"""Windowed photometric BA tests on exactly-rendered synthetic windows.

The reference defers this capability to future work (README.md:54-55), so
(like the geometric BA) these tests ARE its ground-truth harness: known
poses + depths, perturbed initialization, verify joint recovery.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from visual_odometry_rs_tpu.dataset import synthetic
from visual_odometry_rs_tpu.math import pose as pose_mod
from visual_odometry_rs_tpu.math import se3
from visual_odometry_rs_tpu.math.pose import Pose
from visual_odometry_rs_tpu.models import photometric_ba, tracker as tracker_mod
from visual_odometry_rs_tpu.ops import pyramid as pyramid_ops


@pytest.fixture(scope="module")
def window_setup():
    h, w, F = 120, 160, 4
    seq = synthetic.generate_sequence(nb_frames=F, height=h, width=w, seed=12)
    config = tracker_mod.TrackerConfig(height=h, width=w, nb_levels=3, candidate_cap=1024)
    pyr0 = pyramid_ops.mean_pyramid(config.nb_levels, jnp.asarray(seq.grays[0]))
    kf = jax.jit(
        lambda d, p: tracker_mod.precompute_keyframe(config, seq.intrinsics, d, p)
    )(jnp.asarray(seq.depths[0]), pyr0)
    images = jnp.asarray(np.stack(seq.grays)).astype(jnp.float32)
    # ground-truth keyframe->frame motions: inverse(cam_to_world_f) @ cam0
    gt_rel = [
        pose_mod.compose(pose_mod.inverse(p), seq.poses[0]) for p in seq.poses
    ]
    gt_poses = Pose(
        jnp.stack([p.q for p in gt_rel]), jnp.stack([p.t for p in gt_rel])
    )
    return seq, config, kf, images, gt_poses


def _perturbed(gt_poses, scale, seed):
    rng = np.random.default_rng(seed)
    F = gt_poses.q.shape[0]
    xis = jnp.asarray(rng.normal(size=(F, 6)) * scale, jnp.float32)
    xis = xis.at[0].set(0.0)  # frame 0 stays gauge-fixed at identity-ish
    poses = jax.vmap(lambda q, t, xi: pose_mod.compose(Pose(q, t), se3.exp(xi)))(
        gt_poses.q, gt_poses.t, xis
    )
    return Pose(poses.q, poses.t)


def test_window_converges_to_same_minimum(window_setup):
    """Path independence: starting from ground truth and from a perturbed
    init must land on the same energy minimum.  (The minimum itself sits
    ~0.2 px from ground truth — the u8 quantization/resampling bias floor of
    the photometric energy, verified during development by comparing
    energies at GT vs at the solution; recovery closer than that floor is
    not information the energy contains.)"""
    seq, config, kf, images, gt_poses = window_setup
    solve = jax.jit(lambda w: photometric_ba.solve_window(w, max_iterations=25))

    win_gt = photometric_ba.window_from_tracking(
        config, seq.intrinsics, kf.levels, images, gt_poses
    )
    from_gt = solve(win_gt)
    from_pert = solve(win_gt._replace(poses=_perturbed(gt_poses, 3e-3, seed=0)))

    # both stop inside the same floor region (the per-pair energy_tol stop
    # halts before micro-minima hopping; exact coincidence is not attainable)
    np.testing.assert_allclose(
        np.asarray(from_pert.poses.t), np.asarray(from_gt.poses.t), atol=4e-3
    )
    assert abs(float(from_pert.energy) - float(from_gt.energy)) < 0.05 * float(
        from_gt.energy
    )
    # and the minimum is near ground truth (bounded by the bias floor)
    np.testing.assert_allclose(
        np.asarray(from_pert.poses.t), np.asarray(gt_poses.t), atol=1.5e-2
    )


def test_window_idepth_stays_anchored(window_setup):
    """The sensor prior keeps inverse depths near their RGB-D measurements:
    photometric signal from small depth errors sits below the u8
    quantization floor, so without the prior depths would wander (verified
    during development); with it they must stay bounded while poses refine."""
    seq, config, kf, images, gt_poses = window_setup
    init_poses = _perturbed(gt_poses, 3e-3, seed=1)
    win = photometric_ba.window_from_tracking(
        config, seq.intrinsics, kf.levels, images, init_poses
    )
    result = jax.jit(
        lambda w: photometric_ba.solve_window(w, max_iterations=20)
    )(win)
    valid = np.asarray(win.valid)
    dd = np.abs(np.asarray(result.idepth) - np.asarray(win.idepth))[valid]
    rel = dd / np.asarray(win.idepth)[valid]
    assert rel.max() < 0.08, rel.max()
    # and poses stay within the photometric bias floor of ground truth
    err_after = np.abs(np.asarray(result.poses.t) - np.asarray(gt_poses.t)).max()
    assert err_after < 6e-3, err_after


def test_window_noop_at_ground_truth(window_setup):
    seq, config, kf, images, gt_poses = window_setup
    win = photometric_ba.window_from_tracking(
        config, seq.intrinsics, kf.levels, images, gt_poses
    )
    result = jax.jit(
        lambda w: photometric_ba.solve_window(w, max_iterations=5)
    )(win)
    # bounded by the u8 quantization/resampling bias floor (~0.2 px), not exact
    np.testing.assert_allclose(
        np.asarray(result.poses.t), np.asarray(gt_poses.t), atol=5e-3
    )


def test_window_refines_noisy_depth_sensor():
    """Multi-frame photometric evidence recovers depth-sensor noise: 5%
    inverse-depth noise with a variance-matched prior drops ~3x.  Needs
    more parallax than the shared fixture (depth observability scales with
    baseline), so it renders its own window."""
    h, w, F = 120, 160, 6
    seq = synthetic.generate_sequence(
        nb_frames=F, height=h, width=w, seed=3, motion_scale=0.02
    )
    config = tracker_mod.TrackerConfig(height=h, width=w, nb_levels=3, candidate_cap=1024)
    pyr0 = pyramid_ops.mean_pyramid(config.nb_levels, jnp.asarray(seq.grays[0]))
    kf = jax.jit(
        lambda d, p: tracker_mod.precompute_keyframe(config, seq.intrinsics, d, p)
    )(jnp.asarray(seq.depths[0]), pyr0)
    images = jnp.asarray(np.stack(seq.grays)).astype(jnp.float32)
    gt_rel = [pose_mod.compose(pose_mod.inverse(p), seq.poses[0]) for p in seq.poses]
    gt_poses = Pose(jnp.stack([p.q for p in gt_rel]), jnp.stack([p.t for p in gt_rel]))
    win = photometric_ba.window_from_tracking(
        config, seq.intrinsics, kf.levels, images, gt_poses
    )
    rng = np.random.default_rng(0)
    true_idepth = win.idepth
    noisy = true_idepth * jnp.asarray(
        1.0 + 0.05 * rng.normal(size=true_idepth.shape), jnp.float32
    )
    win = win._replace(idepth=jnp.where(win.valid, noisy, true_idepth))
    result = jax.jit(
        lambda w: photometric_ba.solve_window(
            w, max_iterations=30, idepth_prior_weight=400.0
        )
    )(win)
    valid = np.asarray(win.valid)
    err_before = np.abs(np.asarray(win.idepth) - np.asarray(true_idepth))[valid]
    err_after = np.abs(np.asarray(result.idepth) - np.asarray(true_idepth))[valid]
    assert err_after.mean() < err_before.mean() * 0.5, (
        err_before.mean(), err_after.mean(),
    )


def test_window_sharded_matches_single(window_setup):
    """Candidate-sharded window BA on the 8-device mesh matches the
    single-device solve (one psum of the camera system per iteration)."""
    from visual_odometry_rs_tpu.parallel import mesh as mesh_mod

    seq, config, kf, images, gt_poses = window_setup
    win = photometric_ba.window_from_tracking(
        config, seq.intrinsics, kf.levels, images, _perturbed(gt_poses, 3e-3, seed=2)
    )
    ref = jax.jit(lambda w: photometric_ba.solve_window(w, max_iterations=10))(win)
    mesh = mesh_mod.make_mesh((8,), ("points",))
    got = photometric_ba.solve_window_sharded(win, mesh, max_iterations=10)
    np.testing.assert_allclose(
        np.asarray(got.poses.t), np.asarray(ref.poses.t), atol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(got.idepth), np.asarray(ref.idepth), atol=1e-4
    )
    np.testing.assert_allclose(float(got.energy), float(ref.energy), rtol=1e-3)


def test_window_robust_under_occlusion(window_setup):
    """Huber weighting (robust_delta) keeps the window solve near ground
    truth when later frames carry an occluder block that drags the L2
    solve."""
    seq, config, kf, images, gt_poses = window_setup
    occluded = np.asarray(images).copy()
    rng = np.random.default_rng(0)
    # textured occluder: constant blocks have zero gradient and cannot drag
    # GN, so give the outlier region structure
    patch = rng.integers(0, 256, size=(40, 60)).astype(np.float32)
    occluded[1:, 40:80, 50:110] = patch[None]
    win = photometric_ba.window_from_tracking(
        config, seq.intrinsics, kf.levels, jnp.asarray(occluded),
        _perturbed(gt_poses, 2e-3, seed=3),
    )
    l2 = jax.jit(lambda w: photometric_ba.solve_window(w, max_iterations=15))(win)
    huber = jax.jit(
        lambda w: photometric_ba.solve_window(w, max_iterations=15, robust_delta=10.0)
    )(win)
    err_l2 = np.abs(np.asarray(l2.poses.t) - np.asarray(gt_poses.t)).max()
    err_hub = np.abs(np.asarray(huber.poses.t) - np.asarray(gt_poses.t)).max()
    assert err_hub < err_l2, (err_l2, err_hub)


def test_window_brightness_under_exposure_drift(window_setup):
    """brightness=True recovers per-frame gain/bias: an exposure-drifting
    window breaks the plain solve but not the 8-parameter one."""
    seq, config, kf, images, gt_poses = window_setup
    drifted = np.asarray(images).copy()
    gains = [1.0, 1.2, 0.85, 1.15]
    biases = [0.0, 12.0, -10.0, 8.0]
    for f in range(1, drifted.shape[0]):
        drifted[f] = np.clip(gains[f] * drifted[f] + biases[f], 0, 255)
    win = photometric_ba.window_from_tracking(
        config, seq.intrinsics, kf.levels, jnp.asarray(drifted),
        _perturbed(gt_poses, 2e-3, seed=5),
    )
    plain = jax.jit(lambda w: photometric_ba.solve_window(w, max_iterations=15))(win)
    bright = jax.jit(
        lambda w: photometric_ba.solve_window(w, max_iterations=15, brightness=True)
    )(win)
    err_plain = np.abs(np.asarray(plain.poses.t) - np.asarray(gt_poses.t)).max()
    err_bright = np.abs(np.asarray(bright.poses.t) - np.asarray(gt_poses.t)).max()
    assert err_bright < err_plain, (err_plain, err_bright)
    # recovered gains/biases track the injected drift
    ab = np.asarray(bright.ab)
    np.testing.assert_allclose(ab[1:, 0], gains[1:], atol=0.1)
    np.testing.assert_allclose(ab[1:, 1], biases[1:], atol=12.0)


def test_window_sharded_brightness_matches_single(window_setup):
    """Sharded brightness solve matches the single-device brightness solve
    on a drifted window."""
    from visual_odometry_rs_tpu.parallel import mesh as mesh_mod

    seq, config, kf, images, gt_poses = window_setup
    drifted = np.asarray(images).copy()
    for f, (g, b) in enumerate(zip([1.0, 1.2, 0.85, 1.15], [0.0, 12.0, -10.0, 8.0])):
        drifted[f] = np.clip(g * drifted[f] + b, 0, 255)
    win = photometric_ba.window_from_tracking(
        config, seq.intrinsics, kf.levels, jnp.asarray(drifted),
        _perturbed(gt_poses, 2e-3, seed=6),
    )
    ref = jax.jit(
        lambda w: photometric_ba.solve_window(w, max_iterations=8, brightness=True)
    )(win)
    mesh = mesh_mod.make_mesh((8,), ("points",))
    got = photometric_ba.solve_window_sharded(
        win, mesh, max_iterations=8, brightness=True
    )
    np.testing.assert_allclose(np.asarray(got.poses.t), np.asarray(ref.poses.t), atol=2e-4)
    np.testing.assert_allclose(np.asarray(got.ab), np.asarray(ref.ab), atol=1e-2)

def test_window_degenerate_frame_regularized(window_setup):
    """A frame whose candidates are ALL out of view has exactly-zero camera
    diagonal blocks (incl. the brightness gain/bias columns); the additive
    damping floor must keep the Cholesky finite so the REST of the window
    still refines instead of silently no-opping (every step rejected)."""
    seq, config, kf, images, gt_poses = window_setup
    init = _perturbed(gt_poses, 3e-3, seed=4)
    # push the last frame 2 m sideways: every candidate warps out of view
    far = pose_mod.compose(
        Pose(init.q[-1], init.t[-1]),
        se3.exp(jnp.asarray([2.0, 0.0, 0.0, 0.0, 0.0, 0.0], jnp.float32)),
    )
    init = Pose(init.q.at[-1].set(far.q), init.t.at[-1].set(far.t))
    win = photometric_ba.window_from_tracking(
        config, seq.intrinsics, kf.levels, images, init
    )
    result = jax.jit(
        lambda w: photometric_ba.solve_window(w, max_iterations=15, brightness=True)
    )(win)
    assert np.isfinite(np.asarray(result.poses.t)).all()
    assert np.isfinite(float(result.energy))
    # healthy frames (1..F-2) must improve toward ground truth
    err_before = np.abs(np.asarray(init.t)[1:-1] - np.asarray(gt_poses.t)[1:-1]).max()
    err_after = np.abs(
        np.asarray(result.poses.t)[1:-1] - np.asarray(gt_poses.t)[1:-1]
    ).max()
    assert err_after < err_before, (err_before, err_after)

def test_window_sharded_pose_prior_matches_single(window_setup):
    """The sharded solve with a pose prior must equal the unsharded one
    (prior contributions are replicated, added once after the psum)."""
    from visual_odometry_rs_tpu.parallel import mesh as mesh_mod

    seq, config, kf, images, gt_poses = window_setup
    init = _perturbed(gt_poses, 3e-3, seed=9)
    win = photometric_ba.window_from_tracking(
        config, seq.intrinsics, kf.levels, images, init
    )
    F = gt_poses.q.shape[0]
    Hp = jnp.zeros((F, 6, F, 6), jnp.float32)
    for f in range(1, F):
        Hp = Hp.at[f, :, f, :].set(50.0 * jnp.eye(6))  # soft prior at init
    anchors = init
    ref = jax.jit(
        lambda w, H, aq, at: photometric_ba.solve_window(
            w, pose_prior=(H, photometric_ba.Pose(aq, at)), max_iterations=8,
            interp_method="gather",
        )
    )(win, Hp, anchors.q, anchors.t)
    mesh = mesh_mod.make_mesh((8,), ("points",))
    sh = photometric_ba.solve_window_sharded(
        win, mesh, "points", pose_prior=(Hp, anchors), max_iterations=8,
        interp_method="gather",
    )
    np.testing.assert_allclose(np.asarray(sh.poses.t), np.asarray(ref.poses.t), atol=5e-5)
    np.testing.assert_allclose(np.asarray(sh.poses.q), np.asarray(ref.poses.q), atol=5e-5)
    np.testing.assert_allclose(float(sh.energy), float(ref.energy), rtol=1e-4)


def test_window_batched_matches_per_window():
    """solve_window_batched (DP over independent windows, the refinement
    analog of parallel.batch): vmapped results equal per-window solves lane
    for lane, both unsharded and with the batch axis sharded over the
    8-device mesh; per-window prior options are rejected."""
    from visual_odometry_rs_tpu.parallel import mesh as mesh_mod

    h, w, F, B = 96, 128, 3, 8
    wins = []
    for b in range(B):
        seq = synthetic.generate_sequence(
            nb_frames=F, height=h, width=w, seed=100 + b,
            motion_scale=0.008 + 0.002 * b, rot_scale=0.003,
        )
        config = tracker_mod.TrackerConfig(
            height=h, width=w, nb_levels=3, candidate_cap=512,
            interp_method="gather",
        )
        pyr0 = pyramid_ops.mean_pyramid(config.nb_levels, jnp.asarray(seq.grays[0]))
        kf = tracker_mod.precompute_keyframe(
            config, seq.intrinsics, jnp.asarray(seq.depths[0]), pyr0
        )
        images = jnp.asarray(np.stack(seq.grays)).astype(jnp.float32)
        gt_rel = [
            pose_mod.compose(pose_mod.inverse(p), seq.poses[0]) for p in seq.poses
        ]
        gt_poses = Pose(
            jnp.stack([p.q for p in gt_rel]), jnp.stack([p.t for p in gt_rel])
        )
        init = _perturbed(gt_poses, 0.004, seed=b)
        wins.append(
            photometric_ba.window_from_tracking(
                config, seq.intrinsics, kf.levels, images, init
            )
        )

    opts = dict(max_iterations=8, interp_method="gather")
    singles = [photometric_ba.solve_window(w, **opts) for w in wins]
    stacked = photometric_ba.stack_windows(wins)
    batched = photometric_ba.solve_window_batched(stacked, **opts)
    mesh = mesh_mod.make_mesh((8,), ("data",))
    batched_mesh = photometric_ba.solve_window_batched(stacked, mesh, **opts)

    # under vmap XLA lowers the reductions/contractions differently
    # (batched lowering changes), so lanes agree to f32
    # lowering noise accumulated over the LM iterations, not bit-exactly
    for res in (batched, batched_mesh):
        for b, single in enumerate(singles):
            np.testing.assert_allclose(
                np.asarray(res.poses.t[b]), np.asarray(single.poses.t),
                atol=3e-4,
            )
            np.testing.assert_allclose(
                np.asarray(res.idepth[b]), np.asarray(single.idepth),
                rtol=5e-3, atol=1e-3,
            )
            np.testing.assert_allclose(
                float(res.energy[b]), float(single.energy), rtol=2e-2
            )

    # an UNBATCHED prior (no leading lane axis) is a shape error, not a
    # silently broadcast shared prior
    with pytest.raises(ValueError):
        photometric_ba.solve_window_batched(
            stacked,
            pose_prior=(jnp.zeros((F, 6, F, 6)), pose_mod.identity((F,))),
            **opts,
        )
    with pytest.raises(ValueError):
        photometric_ba.solve_window_batched(
            stacked, idepth_init=stacked.idepth[0], **opts
        )


def test_window_batched_per_lane_priors_match_per_window():
    """Per-window pose priors + warm starts in the batched driver (the
    round-3 gap: the marginalized sliding window — the actual product path —
    needs DISTINCT priors per lane).  B windows with distinct random priors
    and distinct warm-start depths must match per-window ``solve_window``
    lane for lane, sharded and unsharded."""
    from visual_odometry_rs_tpu.parallel import mesh as mesh_mod

    h, w, F, B = 96, 128, 3, 4
    rng = np.random.default_rng(7)
    wins, priors, inits = [], [], []
    for b in range(B):
        seq = synthetic.generate_sequence(
            nb_frames=F, height=h, width=w, seed=300 + b,
            motion_scale=0.008 + 0.003 * b, rot_scale=0.003,
        )
        config = tracker_mod.TrackerConfig(
            height=h, width=w, nb_levels=3, candidate_cap=512,
            interp_method="gather",
        )
        pyr0 = pyramid_ops.mean_pyramid(config.nb_levels, jnp.asarray(seq.grays[0]))
        kf = tracker_mod.precompute_keyframe(
            config, seq.intrinsics, jnp.asarray(seq.depths[0]), pyr0
        )
        images = jnp.asarray(np.stack(seq.grays)).astype(jnp.float32)
        gt_rel = [
            pose_mod.compose(pose_mod.inverse(p), seq.poses[0]) for p in seq.poses
        ]
        gt_poses = Pose(
            jnp.stack([p.q for p in gt_rel]), jnp.stack([p.t for p in gt_rel])
        )
        init = _perturbed(gt_poses, 0.004, seed=10 + b)
        wins.append(
            photometric_ba.window_from_tracking(
                config, seq.intrinsics, kf.levels, images, init
            )
        )
        # distinct PSD prior per lane (AᵀA form), anchored at the lane's
        # perturbed init, gauge-zero on frame 0 like the sliding window's
        A = rng.normal(size=(F * 6, F * 6)).astype(np.float32) * (2.0 + b)
        H = (A.T @ A).reshape(F, 6, F, 6)
        H[0] = 0.0
        H[:, :, 0] = 0.0
        priors.append((jnp.asarray(H), init))
        # distinct warm start: a small per-lane relative bump of the depths
        inits.append(
            wins[-1].idepth * (1.0 + 0.01 * (b + 1))
        )

    opts = dict(max_iterations=8, interp_method="gather")
    singles = [
        photometric_ba.solve_window(
            w, pose_prior=p, idepth_init=ii, **opts
        )
        for w, p, ii in zip(wins, priors, inits)
    ]
    stacked = photometric_ba.stack_windows(wins)
    Hp_b = jnp.stack([p[0] for p in priors])
    anchors_b = Pose(
        jnp.stack([p[1].q for p in priors]), jnp.stack([p[1].t for p in priors])
    )
    idepth_init_b = jnp.stack(inits)
    batched = photometric_ba.solve_window_batched(
        stacked, pose_prior=(Hp_b, anchors_b), idepth_init=idepth_init_b, **opts
    )
    mesh = mesh_mod.make_mesh((4,), ("data",))  # B=4 lanes over 4 devices
    batched_mesh = photometric_ba.solve_window_batched(
        stacked, mesh, pose_prior=(Hp_b, anchors_b), idepth_init=idepth_init_b,
        **opts,
    )

    for res in (batched, batched_mesh):
        for b, single in enumerate(singles):
            np.testing.assert_allclose(
                np.asarray(res.poses.t[b]), np.asarray(single.poses.t),
                atol=3e-4,
            )
            np.testing.assert_allclose(
                np.asarray(res.idepth[b]), np.asarray(single.idepth),
                rtol=5e-3, atol=1e-3,
            )
            np.testing.assert_allclose(
                float(res.energy[b]), float(single.energy), rtol=2e-2
            )

    # and the priors actually BITE: a lane's result with its prior differs
    # from the no-prior batched solve (guards against the prior silently
    # dropping out of the vmapped path)
    noprior = photometric_ba.solve_window_batched(stacked, **opts)
    assert float(jnp.abs(batched.poses.t - noprior.poses.t).max()) > 1e-5
