"""Multi-device tests on the virtual 8-device CPU mesh.

The reference has no scaling layer (SURVEY §2.3); these tests pin down the
green-field DP (sequences over a 'data' mesh axis) and TP-analog
(candidate-point sharding with psum reductions) paths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from visual_odometry_rs_tpu.dataset import synthetic
from visual_odometry_rs_tpu.math import pose as pose_mod
from visual_odometry_rs_tpu.models import tracker as tracker_mod
from visual_odometry_rs_tpu.ops import pyramid as pyramid_ops
from visual_odometry_rs_tpu.parallel import batch as batch_mod
from visual_odometry_rs_tpu.parallel import mesh as mesh_mod
from visual_odometry_rs_tpu.parallel import sharded as sharded_mod


def test_eight_virtual_devices():
    assert jax.device_count() >= 8


@pytest.fixture(scope="module")
def seqs():
    # two distinct tiny sequences, replicated to a batch of 8
    return [
        synthetic.generate_sequence(nb_frames=3, height=48, width=64, seed=s)
        for s in (0, 1)
    ]


def _batch_from(seqs, frame, B=8):
    depths = np.stack([seqs[i % 2].depths[frame] for i in range(B)])
    grays = np.stack([seqs[i % 2].grays[frame] for i in range(B)])
    return jnp.asarray(depths), jnp.asarray(grays)


def test_batched_matches_single(seqs):
    """The vmapped batched step must reproduce per-sequence tracking."""
    config = tracker_mod.TrackerConfig(height=48, width=64, nb_levels=3, candidate_cap=256)
    intrinsics = seqs[0].intrinsics
    B = 4
    d0, g0 = _batch_from(seqs, 0, B)
    d1, g1 = _batch_from(seqs, 1, B)

    state = batch_mod.batched_init_state(config, intrinsics, d0, g0)
    new_state, diags = jax.jit(
        lambda s, d, i: batch_mod.batched_track_step(config, intrinsics, s, d, i)
    )(state, d1, g1)

    # single-sequence functional step for comparison
    for i in range(2):
        s_single = batch_mod.init_state(config, intrinsics, d0[i], g0[i])
        ns, dg = batch_mod.track_step(config, intrinsics, s_single, d1[i], g1[i])
        # vmap compiles a different program: f32 reductions reassociate and
        # the LM's discrete accept/reject near the d_energy <= 1.0 stop can
        # flip, so poses agree only within the stopping basin (~1e-2 scale
        # at this resolution; cf. tests/test_oracle.py full-track analysis)
        np.testing.assert_allclose(
            np.asarray(new_state.current_pose.t[i]), np.asarray(ns.current_pose.t),
            atol=5e-3,
        )
        # flow inherits the pose basin difference; tiny flows compare by atol
        np.testing.assert_allclose(
            float(diags.flow[i]), float(dg.flow), rtol=5e-2, atol=5e-3
        )

    # batch entries with the same input must produce identical outputs
    np.testing.assert_allclose(
        np.asarray(new_state.current_pose.t[0]), np.asarray(new_state.current_pose.t[2]),
        atol=1e-6,
    )


def test_sharded_step_runs_on_mesh(seqs):
    """The same batched step under a 'data' mesh sharding: SPMD across 8
    virtual devices, results identical to unsharded."""
    config = tracker_mod.TrackerConfig(height=48, width=64, nb_levels=3, candidate_cap=256)
    intrinsics = seqs[0].intrinsics
    mesh = mesh_mod.make_mesh((8,), ("data",))
    d0, g0 = _batch_from(seqs, 0, 8)
    d1, g1 = _batch_from(seqs, 1, 8)

    state = batch_mod.batched_init_state(config, intrinsics, d0, g0)
    ref_state, ref_diags = jax.jit(
        lambda s, d, i: batch_mod.batched_track_step(config, intrinsics, s, d, i)
    )(state, d1, g1)

    state_sh = mesh_mod.shard_batch(state, mesh)
    d1_sh = mesh_mod.shard_batch(d1, mesh)
    g1_sh = mesh_mod.shard_batch(g1, mesh)
    step = batch_mod.make_sharded_step(config, intrinsics, mesh)
    new_state, diags = step(state_sh, d1_sh, g1_sh)

    # state sharding survived (leading dim split over 8 devices)
    assert len(new_state.current_pose.t.sharding.device_set) == 8
    np.testing.assert_allclose(
        np.asarray(new_state.current_pose.t), np.asarray(ref_state.current_pose.t),
        atol=1e-5,
    )
    np.testing.assert_allclose(
        np.asarray(diags.flow), np.asarray(ref_diags.flow), rtol=1e-4
    )


def test_point_sharded_solve_matches_unsharded(seqs):
    """Candidate-point sharding + psum must match the single-device solve."""
    seq = seqs[0]
    config = tracker_mod.TrackerConfig(height=48, width=64, nb_levels=3, candidate_cap=256)
    intrinsics = seq.intrinsics
    pyr0 = pyramid_ops.mean_pyramid(config.nb_levels, jnp.asarray(seq.grays[0]))
    kf = tracker_mod.precompute_keyframe(
        config, intrinsics, jnp.asarray(seq.depths[0]), pyr0
    )
    obs = kf.levels[0]
    img1 = jnp.asarray(seq.grays[1])

    ref = tracker_mod.solve_level(obs, img1, pose_mod.identity())
    mesh = mesh_mod.make_mesh((8,), ("points",))
    model, failed, nb_iter = sharded_mod.solve_level_point_sharded(
        obs, img1, pose_mod.identity(), mesh
    )
    assert not bool(failed)
    assert int(nb_iter) == int(ref.nb_iter)
    np.testing.assert_allclose(
        np.asarray(model.t), np.asarray(ref.state.model.t), atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(model.q), np.asarray(ref.state.model.q), atol=1e-6
    )


def test_keyframe_switch_select(seqs):
    """Larger motion in one batch element switches only that keyframe.

    flow_threshold 0.5 with a well-within-basin 0.1 m translation (measured
    flow ~0.65 px at the coarsest level when converged) makes the switch
    decision deterministic; the default-motion element stays below."""
    config = tracker_mod.TrackerConfig(
        height=48, width=64, nb_levels=3, candidate_cap=256, flow_threshold=0.5
    )
    seq_small = seqs[0]
    seq_big = synthetic.generate_sequence(
        nb_frames=2, height=48, width=64, seed=3,
        twist_per_frame=[0.1, 0.0, 0.0, 0.0, 0.0, 0.0],
    )
    intrinsics = seq_small.intrinsics
    depths0 = jnp.stack([jnp.asarray(seq_small.depths[0]), jnp.asarray(seq_big.depths[0])])
    grays0 = jnp.stack([jnp.asarray(seq_small.grays[0]), jnp.asarray(seq_big.grays[0])])
    depths1 = jnp.stack([jnp.asarray(seq_small.depths[1]), jnp.asarray(seq_big.depths[1])])
    grays1 = jnp.stack([jnp.asarray(seq_small.grays[1]), jnp.asarray(seq_big.grays[1])])

    state = batch_mod.batched_init_state(config, intrinsics, depths0, grays0)
    new_state, diags = batch_mod.batched_track_step(
        config, intrinsics, state, depths1, grays1
    )
    switched = np.asarray(diags.switched)
    assert not switched[0] and switched[1], switched
    # switched element's keyframe pose became its current pose
    np.testing.assert_allclose(
        np.asarray(new_state.keyframe_pose.t[1]),
        np.asarray(new_state.current_pose.t[1]),
        atol=1e-6,
    )
    # unswitched element's keyframe pose remains identity
    np.testing.assert_allclose(np.asarray(new_state.keyframe_pose.t[0]), np.zeros(3), atol=1e-7)


def test_track_sequence_scan_matches_stepwise(seqs):
    """The lax.scan clip driver must equal repeated track_step calls."""
    config = tracker_mod.TrackerConfig(height=48, width=64, nb_levels=3, candidate_cap=256)
    intrinsics = seqs[0].intrinsics
    seq = seqs[0]
    d = jnp.asarray(np.stack(seq.depths))
    g = jnp.asarray(np.stack(seq.grays))

    state0 = batch_mod.init_state(config, intrinsics, d[0], g[0])
    final, (poses, diags) = jax.jit(
        lambda s, dd, gg: batch_mod.track_sequence(config, intrinsics, s, dd, gg)
    )(state0, d[1:], g[1:])

    s = batch_mod.init_state(config, intrinsics, d[0], g[0])
    for f in range(1, d.shape[0]):
        s, dg = batch_mod.track_step(config, intrinsics, s, d[f], g[f])
        # scan compiles the step body separately -> f32 reassociation plus
        # possible single-iteration LM accept/reject flips at the stop
        # boundary; compare within the stopping basin
        np.testing.assert_allclose(
            np.asarray(poses.t[f - 1]), np.asarray(s.current_pose.t), atol=2e-2
        )
        np.testing.assert_allclose(
            float(diags.flow[f - 1]), float(dg.flow), rtol=5e-2, atol=5e-3
        )
    np.testing.assert_allclose(
        np.asarray(final.current_pose.t), np.asarray(s.current_pose.t), atol=2e-2
    )


def test_batched_track_sequence_sharded(seqs):
    """Batched scan driver runs under a data-sharded mesh and matches vmap-of-scan."""
    config = tracker_mod.TrackerConfig(height=48, width=64, nb_levels=3, candidate_cap=256)
    intrinsics = seqs[0].intrinsics
    B = 8
    d0, g0 = _batch_from(seqs, 0, B)
    clips_d = jnp.stack([_batch_from(seqs, f, B)[0] for f in (1, 2)])  # (F, B, H, W)
    clips_g = jnp.stack([_batch_from(seqs, f, B)[1] for f in (1, 2)])

    mesh = mesh_mod.make_mesh((8,), ("data",))
    state = batch_mod.batched_init_state(config, intrinsics, d0, g0)
    state = mesh_mod.shard_batch(state, mesh)
    clips_d = jax.device_put(
        clips_d,
        jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec(None, "data")),
    )
    clips_g = jax.device_put(
        clips_g,
        jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec(None, "data")),
    )
    final, (poses, diags) = jax.jit(
        lambda s, dd, gg: batch_mod.batched_track_sequence(config, intrinsics, s, dd, gg)
    )(state, clips_d, clips_g)
    assert poses.t.shape == (2, B, 3)
    # same-input batch entries agree
    np.testing.assert_allclose(
        np.asarray(final.current_pose.t[0]), np.asarray(final.current_pose.t[2]), atol=1e-6
    )


def test_track_sequence_switch_branch(seqs):
    """Force a keyframe switch inside the scan: cond branch must match step."""
    config = tracker_mod.TrackerConfig(
        height=48, width=64, nb_levels=3, candidate_cap=256, flow_threshold=0.0
    )  # threshold 0 -> switch every frame: the recompute branch always taken
    intrinsics = seqs[0].intrinsics
    seq = seqs[0]
    d = jnp.asarray(np.stack(seq.depths))
    g = jnp.asarray(np.stack(seq.grays))

    state0 = batch_mod.init_state(config, intrinsics, d[0], g[0])
    final, (poses, diags) = jax.jit(
        lambda s, dd, gg: batch_mod.track_sequence(config, intrinsics, s, dd, gg)
    )(state0, d[1:], g[1:])
    assert bool(diags.switched.all())

    s = batch_mod.init_state(config, intrinsics, d[0], g[0])
    for f in range(1, d.shape[0]):
        s, dg = batch_mod.track_step(config, intrinsics, s, d[f], g[f])
        assert bool(dg.switched)
        # after a switch the keyframe pose itself carries f32 reassociation
        # jitter, and the LM stop criterion is discrete -> the two compiled
        # programs may take different iteration counts; compare loosely
        np.testing.assert_allclose(
            np.asarray(poses.t[f - 1]), np.asarray(s.current_pose.t), atol=1e-2
        )


def test_batched_interp_auto_resolution(monkeypatch):
    """Batched "auto" samples with ``gather`` on every backend: the batched
    tracking functions pass the config through unchanged and
    ``interp.bilinear`` routes "auto" to ``bilinear_gather``."""
    from visual_odometry_rs_tpu.ops import interp as interp_mod

    calls = []
    real_gather = interp_mod.bilinear_gather

    def spy_gather(img, x, y):
        calls.append("gather")
        return real_gather(img, x, y)

    def refuse(img, x, y):
        raise AssertionError("auto must not pick a one-hot sampler")

    monkeypatch.setattr(interp_mod, "bilinear_gather", spy_gather)
    monkeypatch.setattr(interp_mod, "bilinear_onehot", refuse)
    monkeypatch.setattr(interp_mod, "bilinear_onehot_weighted", refuse)
    seq = synthetic.generate_sequence(nb_frames=2, height=48, width=64, seed=3)
    cfg = tracker_mod.TrackerConfig(
        height=48, width=64, nb_levels=3, candidate_cap=256, interp_method="auto"
    )
    B = 2
    d = jnp.broadcast_to(jnp.asarray(seq.depths[0]), (B, 48, 64))
    g = jnp.broadcast_to(jnp.asarray(seq.grays[0]), (B, 48, 64))
    state = batch_mod.batched_init_state(cfg, seq.intrinsics, d, g)
    d1 = jnp.broadcast_to(jnp.asarray(seq.depths[1]), (B, 48, 64))
    g1 = jnp.broadcast_to(jnp.asarray(seq.grays[1]), (B, 48, 64))
    jax.eval_shape(
        lambda s, dd, gg: batch_mod.batched_track_step(cfg, seq.intrinsics, s, dd, gg),
        state, d1, g1,
    )
    jax.eval_shape(
        lambda s, dd, gg: batch_mod.batched_track_sequence(
            cfg, seq.intrinsics, s, dd, gg
        ),
        state, d1[None], g1[None],
    )
    assert calls and set(calls) == {"gather"}


def test_batched_switch_cadence():
    """switch_cadence batches diverse-lane keyframe switches onto check
    frames without hurting tracking.

    Lanes with different motion magnitudes cross the flow threshold on
    different frames; with cadence K the precompute cond may only fire on
    every K-th frame, and deferred lanes still track (stale keyframes stay
    inside the LM convergence basin)."""
    B, F = 4, 6
    mags = [0.02, 0.04, 0.06, 0.08]
    seqs_div = [
        synthetic.generate_sequence(
            nb_frames=F + 1, height=48, width=64, seed=10 + i,
            twist_per_frame=[m, 0.0, 0.0, 0.0, 0.0, 0.0],
        )
        for i, m in enumerate(mags)
    ]
    config = tracker_mod.TrackerConfig(
        height=48, width=64, nb_levels=3, candidate_cap=256, flow_threshold=0.5
    )
    intrinsics = seqs_div[0].intrinsics
    d0 = jnp.stack([jnp.asarray(s.depths[0]) for s in seqs_div])
    g0 = jnp.stack([jnp.asarray(s.grays[0]) for s in seqs_div])
    clips_d = jnp.stack(
        [jnp.stack([jnp.asarray(s.depths[f]) for s in seqs_div]) for f in range(1, F + 1)]
    )
    clips_g = jnp.stack(
        [jnp.stack([jnp.asarray(s.grays[f]) for s in seqs_div]) for f in range(1, F + 1)]
    )

    state0 = batch_mod.batched_init_state(config, intrinsics, d0, g0)
    run = lambda K: jax.jit(
        lambda s, dd, gg: batch_mod.batched_track_sequence(
            config, intrinsics, s, dd, gg, switch_cadence=K
        )
    )(state0, clips_d, clips_g)

    final1, (poses1, diags1) = run(1)
    final3, (poses3, diags3) = run(3)

    sw1 = np.asarray(diags1.switched)  # (F, B)
    sw3 = np.asarray(diags3.switched)
    assert sw1.any(), "scenario must switch keyframes"
    # cadence=1: switches happen on multiple distinct frames (diverse lanes)
    assert (sw1.any(axis=1)).sum() >= 2
    # cadence=3: switches only on check frames (t+1 % 3 == 0 -> frames 2, 5)
    switch_frames = np.nonzero(sw3.any(axis=1))[0]
    assert all(f % 3 == 2 for f in switch_frames), switch_frames
    assert sw3.any(), "deferred switches must still execute"
    # deferral must not derail tracking: both modes land within ~1.5 cm of
    # ground truth (x = 6 * magnitude per lane) and of each other — at this
    # tiny 48x64 resolution per-mode tracking error is already ~5 mm
    t_true = np.zeros((B, 3), np.float32)
    t_true[:, 0] = [6 * m for m in mags]
    for final in (final1, final3):
        np.testing.assert_allclose(
            np.asarray(final.current_pose.t), t_true, atol=1.5e-2
        )
    np.testing.assert_allclose(
        np.asarray(final3.current_pose.t), np.asarray(final1.current_pose.t), atol=2e-2
    )
    # every lane that switched per-frame also switches under cadence
    # (deferral only accumulates flow; pending lanes eventually fire)
    lanes1 = sw1.any(axis=0)
    lanes3 = sw3.any(axis=0)
    assert (lanes3 >= lanes1).all(), (lanes1, lanes3)

def _diverse_batch(B=4, F=6, mags=(0.02, 0.04, 0.06, 0.08), h=48, w=64):
    seqs_div = [
        synthetic.generate_sequence(
            nb_frames=F + 1, height=h, width=w, seed=10 + i,
            twist_per_frame=[m, 0.0, 0.0, 0.0, 0.0, 0.0],
        )
        for i, m in enumerate(mags[:B])
    ]
    d0 = jnp.stack([jnp.asarray(s.depths[0]) for s in seqs_div])
    g0 = jnp.stack([jnp.asarray(s.grays[0]) for s in seqs_div])
    cd = jnp.stack(
        [jnp.stack([jnp.asarray(s.depths[f]) for s in seqs_div]) for f in range(1, F + 1)]
    )
    cg = jnp.stack(
        [jnp.stack([jnp.asarray(s.grays[f]) for s in seqs_div]) for f in range(1, F + 1)]
    )
    return seqs_div[0].intrinsics, d0, g0, cd, cg


def test_switch_subbatch_matches_full_recompute():
    """Sub-batch switch compaction must reproduce the all-lanes recompute:
    identical switch pattern, poses within f32 lowering reassociation.

    The diverse scenario exercises BOTH branches: frames with 1-3 pending
    lanes take the compact path at K=2..3 only when they fit, and the
    all-lanes-switch frame overflows K=1/K=2 into the full-recompute
    fallback — so fallback correctness is covered, not just the happy path."""
    config = tracker_mod.TrackerConfig(
        height=48, width=64, nb_levels=3, candidate_cap=256, flow_threshold=0.5
    )
    intrinsics, d0, g0, cd, cg = _diverse_batch()
    state0 = batch_mod.batched_init_state(config, intrinsics, d0, g0)
    run = lambda K: jax.jit(
        lambda s, dd, gg: batch_mod.batched_track_sequence(
            config, intrinsics, s, dd, gg, switch_subbatch=K
        )
    )(state0, cd, cg)

    ref_final, (ref_poses, ref_diags) = run(0)
    sw = np.asarray(ref_diags.switched)
    assert sw.any() and sw.sum(axis=1).max() >= 3, sw  # needs real overflow
    for K in (1, 2, 3):
        final, (poses, diags) = run(K)
        np.testing.assert_array_equal(
            np.asarray(diags.switched), sw, err_msg=f"K={K}"
        )
        np.testing.assert_allclose(
            np.asarray(poses.t), np.asarray(ref_poses.t), atol=5e-6, err_msg=f"K={K}"
        )
        np.testing.assert_allclose(
            np.asarray(poses.q), np.asarray(ref_poses.q), atol=1e-6, err_msg=f"K={K}"
        )
        np.testing.assert_allclose(
            np.asarray(final.current_pose.t), np.asarray(ref_final.current_pose.t),
            atol=5e-6,
        )


def test_onehot_rows_exact_all_dtypes():
    """The lane-movement primitive is bit-exact for every dtype it carries,
    including f32 bit patterns that encode NaN (moved as bytes, so no 0*NaN
    poisoning through the matmul)."""
    rng = np.random.default_rng(0)
    pending = jnp.asarray(np.array([False, True, False, True, True, False]))
    sel = batch_mod._lane_onehot(pending, 3)
    assert np.asarray(sel).sum() == 3
    f32 = rng.standard_normal((6, 5, 3)).astype(np.float32)
    f32[1, 0, 0] = np.nan
    f32[3, 2, 1] = np.inf
    cases = [
        jnp.asarray(f32),
        jnp.asarray(rng.integers(0, 256, (6, 7), dtype=np.uint8)),
        jnp.asarray(rng.integers(0, 65535, (6, 4, 4), dtype=np.uint16)),
        jnp.asarray(rng.random((6,)) > 0.5),
    ]
    for x in cases:
        got = np.asarray(batch_mod._onehot_rows(sel, x))
        want = np.asarray(x)[np.array([1, 3, 4])]
        np.testing.assert_array_equal(got, want, err_msg=str(x.dtype))
        # scatter direction: zero rows for unselected lanes
        back = np.asarray(batch_mod._onehot_rows(sel.T, jnp.asarray(want)))
        np.testing.assert_array_equal(back[np.array([1, 3, 4])], want)


def test_batched_sequence_chunked_pending_carry():
    """Chunked dispatch with (pending0, frame_offset, return_pending) must
    reproduce the single-dispatch cadence semantics exactly — pending flags
    survive chunk boundaries and check-frame phase follows the GLOBAL frame
    index (round-2 advisor finding on vors_batch --chunk)."""
    config = tracker_mod.TrackerConfig(
        height=48, width=64, nb_levels=3, candidate_cap=256, flow_threshold=0.5
    )
    intrinsics, d0, g0, cd, cg = _diverse_batch()
    K = 3
    state0 = batch_mod.batched_init_state(config, intrinsics, d0, g0)
    _, (ref_poses, ref_diags) = jax.jit(
        lambda s, dd, gg: batch_mod.batched_track_sequence(
            config, intrinsics, s, dd, gg, switch_cadence=K
        )
    )(state0, cd, cg)

    # chunk size 2 with cadence 3: phase would jitter without frame_offset
    s, pending = state0, None
    poses_t, switched = [], []
    for start in range(0, cd.shape[0], 2):
        s, (p, dg), pending = batch_mod.batched_track_sequence(
            config, intrinsics, s, cd[start:start + 2], cg[start:start + 2],
            switch_cadence=K, pending0=pending, frame_offset=start,
            return_pending=True,
        )
        poses_t.append(np.asarray(p.t))
        switched.append(np.asarray(dg.switched))
    np.testing.assert_array_equal(
        np.concatenate(switched), np.asarray(ref_diags.switched)
    )
    np.testing.assert_allclose(
        np.concatenate(poses_t), np.asarray(ref_poses.t), atol=5e-6
    )


def test_track_sequence_scan_matches_stepwise_strict():
    """Single-LM-iteration variant with a sharp tolerance: with DECISIVE
    motion (every level's first step gives a large energy drop) the one
    accept decision per level cannot flip between compilations, so scan and
    stepwise must agree to f32 reassociation only — this preserves the
    regression power that the basin-tolerance full test gives up (e.g. a
    wrong-keyframe bug shifts poses at the 1e-2 scale and WOULD pass the
    loose test)."""
    config = tracker_mod.TrackerConfig(
        height=48, width=64, nb_levels=3, candidate_cap=256, max_iterations=1
    )
    seq = synthetic.generate_sequence(
        nb_frames=3, height=48, width=64, seed=2,
        twist_per_frame=[0.05, 0.01, 0.0, 0.0, 0.0, 0.0],
    )
    intrinsics = seq.intrinsics
    d = jnp.asarray(np.stack(seq.depths))
    g = jnp.asarray(np.stack(seq.grays))

    state0 = batch_mod.init_state(config, intrinsics, d[0], g[0])
    final, (poses, diags) = jax.jit(
        lambda s, dd, gg: batch_mod.track_sequence(config, intrinsics, s, dd, gg)
    )(state0, d[1:], g[1:])

    s = batch_mod.init_state(config, intrinsics, d[0], g[0])
    for f in range(1, d.shape[0]):
        s, dg = batch_mod.track_step(config, intrinsics, s, d[f], g[f])
        # residual difference is reassociation amplified through the 6x6
        # Cholesky solves (~2.5e-4 measured) — 40x below the ~1e-2 shifts a
        # wiring bug produces
        np.testing.assert_allclose(
            np.asarray(poses.t[f - 1]), np.asarray(s.current_pose.t), atol=5e-4
        )
        np.testing.assert_allclose(
            float(diags.flow[f - 1]), float(dg.flow), rtol=1e-2, atol=1e-3
        )
    np.testing.assert_allclose(
        np.asarray(final.current_pose.t), np.asarray(s.current_pose.t), atol=5e-4
    )


@pytest.mark.parametrize(
    "opts",
    [
        dict(robust_delta=20.0),
        dict(brightness_model=True),
        dict(robust_delta=20.0, brightness_model=True),
    ],
    ids=["robust", "brightness", "robust+brightness"],
)
def test_batched_sequence_option_crossproduct(opts):
    """Round-3 verdict item 7: the robust/brightness tracker extensions must
    work through the batched fused-scan driver (cadence 1 AND >1) on the
    8-device mesh, agreeing with the single-stream scan driver per lane.

    The round-2 suite only ran the plain config batched; the extension
    cross-product was an untested shape/select surface."""
    config = tracker_mod.TrackerConfig(
        height=48, width=64, nb_levels=3, candidate_cap=256,
        flow_threshold=0.5, **opts,
    )
    intrinsics, d0, g0, cd, cg = _diverse_batch()
    B = d0.shape[0]

    mesh = mesh_mod.make_mesh((8,), ("data",))
    # pad batch 4 -> 8 lanes for the mesh by repeating (distinct data per
    # device still exercised via the first 4 lanes)
    d0_8 = jnp.concatenate([d0, d0], axis=0)
    g0_8 = jnp.concatenate([g0, g0], axis=0)
    cd_8 = jnp.concatenate([cd, cd], axis=1)
    cg_8 = jnp.concatenate([cg, cg], axis=1)

    state0 = batch_mod.batched_init_state(config, intrinsics, d0_8, g0_8)
    state0 = mesh_mod.shard_batch(state0, mesh)
    from jax.sharding import NamedSharding, PartitionSpec as P

    sh = NamedSharding(mesh, P(None, "data"))
    cd_8 = jax.device_put(cd_8, sh)
    cg_8 = jax.device_put(cg_8, sh)

    for cadence in (1, 3):
        final, (poses, diags) = jax.jit(
            lambda s, dd, gg: batch_mod.batched_track_sequence(
                config, intrinsics, s, dd, gg, switch_cadence=cadence
            )
        )(state0, cd_8, cg_8)
        assert bool(jnp.all(jnp.isfinite(poses.t)))
        assert not bool(diags.failed.any())
        # duplicated lanes must agree exactly (same data, same program)
        np.testing.assert_allclose(
            np.asarray(final.current_pose.t[:B]),
            np.asarray(final.current_pose.t[B:]), atol=1e-6,
        )
        if cadence == 1:
            # per-lane agreement with the single-stream scan driver
            for lane in range(B):
                s1 = batch_mod.init_state(
                    config, intrinsics, d0[lane], g0[lane]
                )
                f1, (p1, dg1) = jax.jit(
                    lambda s, dd, gg: batch_mod.track_sequence(
                        config, intrinsics, s, dd, gg
                    )
                )(s1, cd[:, lane], cg[:, lane])
                # vmap reassociation + discrete LM stop flips: basin-level
                np.testing.assert_allclose(
                    np.asarray(final.current_pose.t[lane]),
                    np.asarray(f1.current_pose.t), atol=2e-2,
                )


def test_batched_relocalization_recovers_kidnapped_lane():
    """In-graph relocalization in the fused batched scan (RelocRing): a
    kidnapped lane recovers against its keyframe ring while a healthy lane
    in the same batch is untouched (matches its ring-free solo run)."""
    step = [0.09, 0.01, 0.005, 0.0, 0.06, 0.0]
    total = -4.0 * np.asarray(step)
    small = [0.01, 0.002, 0.001, 0.0, 0.005, 0.0]
    twists = np.asarray([step] * 4 + [list(total)] + [small, small], np.float32)
    seq_kid = synthetic.generate_sequence(
        nb_frames=len(twists) + 1, height=120, width=160, seed=23,
        twist_per_frame=twists,
    )
    seq_ok = synthetic.generate_sequence(
        nb_frames=len(twists) + 1, height=120, width=160, seed=24,
        motion_scale=0.012, rot_scale=0.004,
    )
    config = tracker_mod.TrackerConfig(
        height=120, width=160, nb_levels=3, candidate_cap=1024,
        interp_method="gather", depth_scale=5000.0,
        relocalize_window=4, relocalize_energy_accept=150.0,
    )
    F = len(twists)
    d0 = jnp.stack([jnp.asarray(seq_kid.depths[0]), jnp.asarray(seq_ok.depths[0])])
    g0 = jnp.stack([jnp.asarray(seq_kid.grays[0]), jnp.asarray(seq_ok.grays[0])])
    clip_d = jnp.stack([
        jnp.stack([jnp.asarray(seq_kid.depths[i]), jnp.asarray(seq_ok.depths[i])])
        for i in range(1, F + 1)
    ])
    clip_g = jnp.stack([
        jnp.stack([jnp.asarray(seq_kid.grays[i]), jnp.asarray(seq_ok.grays[i])])
        for i in range(1, F + 1)
    ])
    state = batch_mod.batched_init_state(config, seq_kid.intrinsics, d0, g0)
    ring = batch_mod.batched_init_ring(config, state)
    final, (poses, diags), ring_out = batch_mod.batched_track_sequence(
        config, seq_kid.intrinsics, state, clip_d, clip_g, reloc_ring=ring
    )
    reloc = np.asarray(diags.relocalized)  # (F, B)
    assert reloc[:, 0].any(), "kidnapped lane must relocalize"
    assert not reloc[:, 1].any(), "healthy lane must not relocalize"

    # kidnapped lane's tail returns to ground truth
    for f in (F - 2, F - 1):
        err = float(np.linalg.norm(
            np.asarray(poses.t[f, 0]) - np.asarray(seq_kid.poses[f + 1].t)
        ))
        assert err < 0.02, (f, err)

    # the healthy lane matches its own ring-free run to lowering noise
    cfg0 = tracker_mod.TrackerConfig(
        height=120, width=160, nb_levels=3, candidate_cap=1024,
        interp_method="gather", depth_scale=5000.0,
    )
    d0s = jnp.stack([jnp.asarray(seq_ok.depths[0])] * 2)
    g0s = jnp.stack([jnp.asarray(seq_ok.grays[0])] * 2)
    clip_ds = jnp.stack([
        jnp.stack([jnp.asarray(seq_ok.depths[i])] * 2) for i in range(1, F + 1)
    ])
    clip_gs = jnp.stack([
        jnp.stack([jnp.asarray(seq_ok.grays[i])] * 2) for i in range(1, F + 1)
    ])
    state0 = batch_mod.batched_init_state(cfg0, seq_ok.intrinsics, d0s, g0s)
    _, (poses0, _) = batch_mod.batched_track_sequence(
        cfg0, seq_ok.intrinsics, state0, clip_ds, clip_gs
    )
    np.testing.assert_allclose(
        np.asarray(poses.t[:, 1]), np.asarray(poses0.t[:, 0]), atol=1e-5
    )


def test_batched_relocalization_noop_on_healthy_batch():
    """With the ring threaded but no lane ever lost, trajectories equal the
    ring-free run (the lost-detector eval and the two added conds must not
    perturb the pose dataflow)."""
    B, F = 3, 5
    seqs = [
        synthetic.generate_sequence(
            nb_frames=F + 1, height=96, width=128, seed=40 + b,
            motion_scale=0.01, rot_scale=0.003,
        )
        for b in range(B)
    ]
    intr = seqs[0].intrinsics
    kw = dict(height=96, width=128, nb_levels=3, candidate_cap=512,
              interp_method="gather", depth_scale=5000.0)
    cfg_on = tracker_mod.TrackerConfig(relocalize_window=3, **kw)
    cfg_off = tracker_mod.TrackerConfig(**kw)
    d0 = jnp.stack([jnp.asarray(s.depths[0]) for s in seqs])
    g0 = jnp.stack([jnp.asarray(s.grays[0]) for s in seqs])
    clip_d = jnp.stack([
        jnp.stack([jnp.asarray(s.depths[i]) for s in seqs])
        for i in range(1, F + 1)
    ])
    clip_g = jnp.stack([
        jnp.stack([jnp.asarray(s.grays[i]) for s in seqs])
        for i in range(1, F + 1)
    ])
    state_on = batch_mod.batched_init_state(cfg_on, intr, d0, g0)
    ring = batch_mod.batched_init_ring(cfg_on, state_on)
    _, (poses_on, diags_on), _ = batch_mod.batched_track_sequence(
        cfg_on, intr, state_on, clip_d, clip_g, reloc_ring=ring
    )
    state_off = batch_mod.batched_init_state(cfg_off, intr, d0, g0)
    _, (poses_off, diags_off) = batch_mod.batched_track_sequence(
        cfg_off, intr, state_off, clip_d, clip_g
    )
    assert not np.asarray(diags_on.relocalized).any()
    np.testing.assert_array_equal(
        np.asarray(diags_on.switched), np.asarray(diags_off.switched)
    )
    np.testing.assert_allclose(
        np.asarray(poses_on.t), np.asarray(poses_off.t), atol=1e-7
    )
    np.testing.assert_allclose(
        np.asarray(poses_on.q), np.asarray(poses_off.q), atol=1e-7
    )


def test_batched_relocalization_sharded_matches_unsharded():
    """The RelocRing threads through the data-sharded SPMD serving loop:
    sharding the batch (state + ring + clips) over the 8-device mesh
    reproduces the unsharded run, including which lanes relocalized."""
    B, F = 8, 6
    step = [0.09, 0.01, 0.005, 0.0, 0.06, 0.0]
    total = -3.0 * np.asarray(step)
    small = [0.01, 0.002, 0.001, 0.0, 0.005, 0.0]
    twists_kid = np.asarray([step] * 3 + [list(total)] + [small, small], np.float32)
    seqs = []
    for b in range(B):
        if b % 2 == 0:
            seqs.append(synthetic.generate_sequence(
                nb_frames=F + 1, height=96, width=128, seed=60 + b,
                twist_per_frame=twists_kid,
            ))
        else:
            seqs.append(synthetic.generate_sequence(
                nb_frames=F + 1, height=96, width=128, seed=60 + b,
                motion_scale=0.01, rot_scale=0.003,
            ))
    config = tracker_mod.TrackerConfig(
        height=96, width=128, nb_levels=3, candidate_cap=512,
        interp_method="gather", depth_scale=5000.0,
        relocalize_window=3, relocalize_energy_accept=150.0,
    )
    intr = seqs[0].intrinsics
    d0 = jnp.stack([jnp.asarray(s.depths[0]) for s in seqs])
    g0 = jnp.stack([jnp.asarray(s.grays[0]) for s in seqs])
    clip_d = jnp.stack([
        jnp.stack([jnp.asarray(s.depths[i]) for s in seqs])
        for i in range(1, F + 1)
    ])
    clip_g = jnp.stack([
        jnp.stack([jnp.asarray(s.grays[i]) for s in seqs])
        for i in range(1, F + 1)
    ])

    def run(shard):
        state = batch_mod.batched_init_state(config, intr, d0, g0)
        ring = batch_mod.batched_init_ring(config, state)
        dd, gg = clip_d, clip_g
        if shard:
            mesh = mesh_mod.make_mesh((8,), ("data",))
            from jax.sharding import NamedSharding, PartitionSpec as P

            state = mesh_mod.shard_batch(state, mesh)
            ring = mesh_mod.shard_batch(ring, mesh)
            sh = NamedSharding(mesh, P(None, "data"))
            dd = jax.device_put(dd, sh)
            gg = jax.device_put(gg, sh)
        return batch_mod.batched_track_sequence(
            config, intr, state, dd, gg, reloc_ring=ring
        )

    _, (poses_u, diags_u), ring_u = run(False)
    _, (poses_s, diags_s), ring_s = run(True)
    assert np.asarray(diags_u.relocalized).any()  # the kidnap lanes recover
    np.testing.assert_array_equal(
        np.asarray(diags_s.relocalized), np.asarray(diags_u.relocalized)
    )
    np.testing.assert_array_equal(
        np.asarray(diags_s.switched), np.asarray(diags_u.switched)
    )
    # SPMD partitioning changes the f32 reduction lowering; deviations
    # compound over the LM iterations of 6 frames
    np.testing.assert_allclose(
        np.asarray(poses_s.t), np.asarray(poses_u.t), atol=1e-4
    )
    np.testing.assert_array_equal(
        np.asarray(ring_s.count), np.asarray(ring_u.count)
    )


def test_batched_relocalization_full_crossproduct():
    """RelocRing x switch_cadence=3 x switch_subbatch=2 x robust+brightness
    on the 8-device mesh (VERDICT round-3 item 2: the recovery layer at its
    full option cross-product, not just the plain cadence-1 configuration).

    The kidnapped lane is engineered so its flow PENDS before a check frame
    and the kidnap jump lands ON that check frame — the exact pending/lost
    interaction called out in the round-3 review.  A lost frame must never
    become the map anchor: the pending switch is DEFERRED past the lost
    check (it must not switch to the lost frame, nor write it into the
    ring), recovery re-anchors on the matching ring keyframe in the same
    step, and the deferred switch fires at the next healthy check.
    Healthy lanes must match their ring-free, subbatch-free, unsharded runs
    lane-by-lane; the kidnapped lane must recover to ground truth.
    """
    B, F = 8, 12
    # checks at (t+1) % 3 == 0 -> scan steps t = 2, 5, 8, 11.
    # kid lane: steady over-threshold flow -> switches at t=2 (ring
    # keyframe K1 at pose 3s) and t=5 (K2 at 6s, becomes current keyframe);
    # pends again by t=7; the t=8 check frame jumps BACK to exactly K1's
    # pose (-5s; equal-step twists commute, so exp(s)^-5 == exp(-5s)): far
    # from K2 -> lost, near K1 -> recovery verifies.  Small motion after;
    # the deferred pending switch fires at the t=11 check.  (Step size
    # 0.3x the kidnap test's: large steps mistrack on this scene, and THIS
    # test asserts mid-run accuracy, not just tail recovery.)
    step = 0.3 * np.asarray([0.09, 0.01, 0.005, 0.0, 0.06, 0.0])
    small = [0.008, 0.002, 0.001, 0.0, 0.004, 0.0]
    kid_jump = list(-5.0 * step)
    twists_kid = np.asarray(
        [list(step)] * 8 + [kid_jump] + [small] * 3, np.float32
    )
    seqs = [
        synthetic.generate_sequence(
            nb_frames=F + 1, height=120, width=160, seed=23,
            twist_per_frame=twists_kid,
        )
    ]
    for b in range(1, B):
        seqs.append(synthetic.generate_sequence(
            nb_frames=F + 1, height=120, width=160, seed=70 + b,
            motion_scale=0.012, rot_scale=0.004,
        ))
    intr = seqs[0].intrinsics
    kw = dict(
        height=120, width=160, nb_levels=3, candidate_cap=1024,
        interp_method="gather", depth_scale=5000.0,
        robust_delta=20.0, brightness_model=True,
    )
    cfg_on = tracker_mod.TrackerConfig(
        relocalize_window=3, relocalize_energy_accept=150.0, **kw
    )
    cfg_off = tracker_mod.TrackerConfig(**kw)
    d0 = jnp.stack([jnp.asarray(s.depths[0]) for s in seqs])
    g0 = jnp.stack([jnp.asarray(s.grays[0]) for s in seqs])
    clip_d = jnp.stack([
        jnp.stack([jnp.asarray(s.depths[i]) for s in seqs])
        for i in range(1, F + 1)
    ])
    clip_g = jnp.stack([
        jnp.stack([jnp.asarray(s.grays[i]) for s in seqs])
        for i in range(1, F + 1)
    ])

    # full-fat run: ring + cadence 3 + subbatch 2, sharded over the mesh
    mesh = mesh_mod.make_mesh((8,), ("data",))
    from jax.sharding import NamedSharding, PartitionSpec as P

    state = batch_mod.batched_init_state(cfg_on, intr, d0, g0)
    ring = batch_mod.batched_init_ring(cfg_on, state)
    state = mesh_mod.shard_batch(state, mesh)
    ring = mesh_mod.shard_batch(ring, mesh)
    sh = NamedSharding(mesh, P(None, "data"))
    final, (poses, diags), ring_out = batch_mod.batched_track_sequence(
        cfg_on, intr, state, jax.device_put(clip_d, sh),
        jax.device_put(clip_g, sh), switch_cadence=3, switch_subbatch=2,
        reloc_ring=ring,
    )
    reloc = np.asarray(diags.relocalized)  # (F, B)
    switched = np.asarray(diags.switched)
    assert reloc[:, 0].any(), "kidnapped lane must relocalize"
    assert not reloc[:, 1:].any(), "healthy lanes must not relocalize"
    # the engineered pending/lost collision: the kid lane had switched
    # before the kidnap (ring keyframes exist), was pending at the t=8
    # lost check, did NOT anchor on the lost frame (deferred), relocalized
    # in the same step, and the deferred switch fired at the t=11 check
    assert switched[2, 0] and switched[5, 0], switched[:, 0]
    assert reloc[8, 0] and not switched[8, 0], (switched[:, 0], reloc[:, 0])
    assert switched[11, 0], switched[:, 0]
    # kidnapped lane stays accurate mid-run AND through the recovery
    for f in (1, 5, 8, F - 2, F - 1):
        err = float(np.linalg.norm(
            np.asarray(poses.t[f, 0]) - np.asarray(seqs[0].poses[f + 1].t)
        ))
        assert err < 0.03, (f, err)

    # healthy lanes match the ring-free / subbatch-free / unsharded run at
    # the same cadence (recovery and compaction must not perturb them)
    state0 = batch_mod.batched_init_state(cfg_off, intr, d0, g0)
    _, (poses0, diags0) = batch_mod.batched_track_sequence(
        cfg_off, intr, state0, clip_d, clip_g, switch_cadence=3
    )
    np.testing.assert_array_equal(
        switched[:, 1:], np.asarray(diags0.switched)[:, 1:]
    )
    np.testing.assert_allclose(
        np.asarray(poses.t[:, 1:]), np.asarray(poses0.t)[:, 1:], atol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(poses.q[:, 1:]), np.asarray(poses0.q)[:, 1:], atol=1e-4
    )


def test_fused_scan_production_shape_soak():
    """Production-operating-point soak on the 8-device CPU mesh (VERDICT
    round-3 item 7): the fused batched scan at 640x480 / 6 levels /
    cap 4096, B=8, with forced switching + sub-batch compaction + the
    relocalization ring, sharded over the mesh.  Big shapes otherwise run
    only inside accelerator benches, so shape/memory/layout bugs at the operating
    point `bench.py` claims would be invisible to CI.  ~2-6 min on the
    1-core test box (compile-dominated)."""
    B, F = 8, 4
    h, w = 480, 640
    seqs = [
        synthetic.generate_sequence(
            nb_frames=F + 1, height=h, width=w, seed=90 + b,
            motion_scale=0.008 + 0.002 * b, rot_scale=0.002,
        )
        for b in range(B)
    ]
    intr = seqs[0].intrinsics
    config = tracker_mod.TrackerConfig(
        height=h, width=w, nb_levels=6, candidate_cap=4096,
        # force every lane to pend every frame: every check frame takes the
        # recompute path (and with 8 > subbatch lanes pending, the overflow
        # all-lanes branch too — both compaction branches compile and run)
        flow_threshold=0.01,
        relocalize_window=2,
    )
    d0 = jnp.stack([jnp.asarray(s.depths[0]) for s in seqs])
    g0 = jnp.stack([jnp.asarray(s.grays[0]) for s in seqs])
    clip_d = jnp.stack([
        jnp.stack([jnp.asarray(s.depths[i]) for s in seqs])
        for i in range(1, F + 1)
    ])
    clip_g = jnp.stack([
        jnp.stack([jnp.asarray(s.grays[i]) for s in seqs])
        for i in range(1, F + 1)
    ])
    mesh = mesh_mod.make_mesh((8,), ("data",))
    from jax.sharding import NamedSharding, PartitionSpec as P

    state = batch_mod.batched_init_state(config, intr, d0, g0)
    ring = batch_mod.batched_init_ring(config, state)
    state = mesh_mod.shard_batch(state, mesh)
    ring = mesh_mod.shard_batch(ring, mesh)
    sh = NamedSharding(mesh, P(None, "data"))
    final, (poses, diags), ring_out = batch_mod.batched_track_sequence(
        config, intr, state, jax.device_put(clip_d, sh),
        jax.device_put(clip_g, sh), switch_cadence=2, switch_subbatch=2,
        reloc_ring=ring,
    )
    switched = np.asarray(diags.switched)
    assert switched[1].all() and switched[3].all()  # checks at t=1,3
    assert not switched[0].any() and not switched[2].any()
    assert np.isfinite(np.asarray(poses.t)).all()
    assert np.isfinite(np.asarray(poses.q)).all()
    # forced per-check switching keeps tracking healthy at full resolution
    for b in range(B):
        err = float(np.linalg.norm(
            np.asarray(poses.t[-1, b]) - np.asarray(seqs[b].poses[F].t)
        ))
        assert err < 0.05, (b, err)
    # the ring recorded the switches (slots filled up to R)
    assert int(np.asarray(ring_out.count).min()) >= 2


# ---------------------------------------------------------------------------
# Warm start + per-level iteration budgets (round 5)
# ---------------------------------------------------------------------------


def test_warm_start_velocity_cuts_iterations_and_holds_accuracy():
    """constant_velocity warm start on smooth diverse motion: no failures,
    total LM iterations strictly below the reference constant-position
    init's, and per-lane final poses at least as accurate vs ground truth.
    (The fps study lives in tools/ab_warmstart.py; this pins the
    iteration mechanism and the accuracy direction.)"""
    import dataclasses

    B, F = 4, 6
    seqs_div = [
        synthetic.generate_sequence(
            nb_frames=F + 1, height=48, width=64, seed=30 + i,
            twist_per_frame=[m, 0.0, 0.0, 0.0, 0.001, 0.0],
        )
        for i, m in enumerate((0.01, 0.02, 0.03, 0.04))
    ]
    intr = seqs_div[0].intrinsics
    d0 = jnp.stack([jnp.asarray(s.depths[0]) for s in seqs_div])
    g0 = jnp.stack([jnp.asarray(s.grays[0]) for s in seqs_div])
    cd = jnp.stack([
        jnp.stack([jnp.asarray(s.depths[f]) for s in seqs_div])
        for f in range(1, F + 1)
    ])
    cg = jnp.stack([
        jnp.stack([jnp.asarray(s.grays[f]) for s in seqs_div])
        for f in range(1, F + 1)
    ])
    cfg_cp = tracker_mod.TrackerConfig(
        height=48, width=64, nb_levels=3, candidate_cap=256
    )
    cfg_cv = dataclasses.replace(cfg_cp, warm_start="constant_velocity")

    out = {}
    for name, cfg in (("cp", cfg_cp), ("cv", cfg_cv)):
        state = batch_mod.batched_init_state(cfg, intr, d0, g0)
        _, (poses, diags) = jax.jit(
            lambda s, dd, gg, cfg=cfg: batch_mod.batched_track_sequence(
                cfg, intr, s, dd, gg
            )
        )(state, cd, cg)
        assert not bool(np.asarray(diags.failed).any()), name
        err = np.array([
            [
                np.linalg.norm(
                    np.asarray(poses.t[f, b]) - np.asarray(seqs_div[b].poses[f + 1].t)
                )
                for f in range(F)
            ]
            for b in range(B)
        ])
        out[name] = (int(np.asarray(diags.nb_iters).sum()), err.max())

    iters_cp, err_cp = out["cp"]
    iters_cv, err_cv = out["cv"]
    assert iters_cv < iters_cp, (iters_cv, iters_cp)
    # 48x64 with up-to-4cm/frame lanes tracks to ~1e-2; the warm start must
    # not degrade it (it measured slightly BETTER: 0.0117 vs 0.0124)
    assert err_cv <= err_cp * 1.2 and err_cv < 0.02, (err_cv, err_cp)


def test_warm_start_velocity_chunked_carry_exact():
    """Chunked dispatch with (prev_pose0, return_prev) must reproduce the
    single-dispatch constant-velocity scan exactly — the velocity carry
    survives chunk boundaries (vors_batch --chunk threading)."""
    import dataclasses

    config = dataclasses.replace(
        tracker_mod.TrackerConfig(
            height=48, width=64, nb_levels=3, candidate_cap=256,
            flow_threshold=0.5,
        ),
        warm_start="constant_velocity",
    )
    intrinsics, d0, g0, cd, cg = _diverse_batch()
    state0 = batch_mod.batched_init_state(config, intrinsics, d0, g0)
    _, (ref_poses, ref_diags) = jax.jit(
        lambda s, dd, gg: batch_mod.batched_track_sequence(
            config, intrinsics, s, dd, gg
        )
    )(state0, cd, cg)

    s, pending, prev = state0, None, None
    poses_t, switched = [], []
    for start in range(0, cd.shape[0], 2):
        s, (p, dg), pending, prev = batch_mod.batched_track_sequence(
            config, intrinsics, s, cd[start:start + 2], cg[start:start + 2],
            pending0=pending, frame_offset=start,
            return_pending=True, prev_pose0=prev, return_prev=True,
        )
        poses_t.append(np.asarray(p.t))
        switched.append(np.asarray(dg.switched))
    np.testing.assert_array_equal(
        np.concatenate(switched), np.asarray(ref_diags.switched)
    )
    np.testing.assert_allclose(
        np.concatenate(poses_t), np.asarray(ref_poses.t), atol=1e-7
    )


def test_level_iterations_uniform_cap_matches_default():
    """level_max_iterations=(20, 20, 20) is numerically IDENTICAL to the
    reference's single cap (it compiles the same per-level solves)."""
    import dataclasses

    base = tracker_mod.TrackerConfig(
        height=48, width=64, nb_levels=3, candidate_cap=256
    )
    uniform = dataclasses.replace(base, level_max_iterations=(20, 20, 20))
    intrinsics, d0, g0, cd, cg = _diverse_batch(B=2, mags=(0.02, 0.05))
    for cfg, ref_cfg in ((uniform, base),):
        sa = batch_mod.batched_init_state(cfg, intrinsics, d0, g0)
        _, (pa, _) = jax.jit(
            lambda s, dd, gg: batch_mod.batched_track_sequence(
                cfg, intrinsics, s, dd, gg
            )
        )(sa, cd, cg)
        sb = batch_mod.batched_init_state(ref_cfg, intrinsics, d0, g0)
        _, (pb, _) = jax.jit(
            lambda s, dd, gg: batch_mod.batched_track_sequence(
                ref_cfg, intrinsics, s, dd, gg
            )
        )(sb, cd, cg)
        np.testing.assert_array_equal(np.asarray(pa.t), np.asarray(pb.t))
        np.testing.assert_array_equal(np.asarray(pa.q), np.asarray(pb.q))


def test_level_iterations_budget_respected():
    """A per-level cap actually bounds that level's LM iterations (the
    nb_iters diagnostic), and bad budget shapes fail loudly."""
    import dataclasses

    import pytest as _pytest

    base = tracker_mod.TrackerConfig(
        height=48, width=64, nb_levels=3, candidate_cap=256
    )
    budget = dataclasses.replace(base, level_max_iterations=(20, 5, 3))
    intrinsics, d0, g0, cd, cg = _diverse_batch(B=2, mags=(0.03, 0.06))
    s = batch_mod.batched_init_state(budget, intrinsics, d0, g0)
    _, (_, diags) = jax.jit(
        lambda s, dd, gg: batch_mod.batched_track_sequence(
            budget, intrinsics, s, dd, gg
        )
    )(s, cd, cg)
    iters = np.asarray(diags.nb_iters)  # (F, B, L)
    # the driver allows cap+1 evaluations before the too_many stop lands
    assert iters[..., 1].max() <= 5 + 1, iters[..., 1].max()
    assert iters[..., 2].max() <= 3 + 1, iters[..., 2].max()

    bad = dataclasses.replace(base, level_max_iterations=(20, 5))
    with _pytest.raises(ValueError):
        bad.level_iterations(0)
    with _pytest.raises(ValueError):
        tracker_mod.warm_start_init(
            dataclasses.replace(base, warm_start="bogus"),
            pose_mod.identity(), pose_mod.identity(),
        )
