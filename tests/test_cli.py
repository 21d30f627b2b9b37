"""CLI end-to-end test: write a synthetic TUM-layout sequence to disk, run
the vors_track-equivalent entry point, parse stdout, evaluate ATE.

This is the product-level test the reference delegates to manual runs +
an external evaluation repo (SURVEY §4).
"""

import io
import os
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest

from visual_odometry_rs_tpu.cli import vors_track
from visual_odometry_rs_tpu.dataset import synthetic, tum_rgbd
from visual_odometry_rs_tpu.eval import ate
from visual_odometry_rs_tpu.math import pose as pose_mod


def test_cli_tracks_and_prints_trajectory(tmp_path, capsys):
    # small size for test speed; intrinsics=None auto-scales fr1-like values
    seq = synthetic.generate_sequence(nb_frames=4, height=120, width=160, seed=5)
    assoc_path = tum_rgbd.write_sequence(str(tmp_path), seq.grays, seq.depths, seq.timestamps)

    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = vors_track.main(
            ["fr1", assoc_path, "--nb-levels", "4", "--candidate-cap", "2048"]
        )
    assert rc == 0
    out = buf.getvalue()
    frames = tum_rgbd.parse_trajectory(out)
    assert len(frames) == 3  # frames 1..3 (frame 0 initializes)

    estimated = [pose_mod.identity()] + [f.pose for f in frames]
    # presets auto-rescale to the render's exact intrinsics -> the CLI path
    # is now millimeter-accurate end to end, not just plumbing
    err = ate.ate_rmse(estimated, seq.poses)
    assert err < 5e-3, err


def test_cli_accurate_with_matching_intrinsics(tmp_path):
    # Render at 640x480-scaled-down intrinsics and give the CLI the same via
    # camera preset: use icl at its native 640x480 shape scaled.
    seq = synthetic.generate_sequence(nb_frames=4, height=120, width=160, seed=6)
    assoc_path = tum_rgbd.write_sequence(str(tmp_path), seq.grays, seq.depths, seq.timestamps)

    # drive the library the way the CLI does but with correct intrinsics
    import jax.numpy as jnp

    from visual_odometry_rs_tpu.models import tracker as tracker_mod

    assocs = tum_rgbd.load_associations(assoc_path)
    depth0, gray0 = tum_rgbd.read_images(assocs[0])
    config = tracker_mod.TrackerConfig(height=120, width=160, nb_levels=4, candidate_cap=2048)
    trk = tracker_mod.init_tracker(
        config, seq.intrinsics, assocs[0].depth_timestamp,
        jnp.asarray(depth0), assocs[0].color_timestamp, jnp.asarray(gray0),
    )
    estimated = [pose_mod.identity()]
    for a in assocs[1:]:
        depth, gray = tum_rgbd.read_images(a)
        trk.track(a.depth_timestamp, jnp.asarray(depth), a.color_timestamp, jnp.asarray(gray))
        estimated.append(trk.current_frame()[1])
    err = ate.ate_rmse(estimated, seq.poses)
    assert err < 5e-3, err


def test_cli_missing_file(capsys):
    rc = vors_track.main(["fr1", "/nonexistent/associations.txt"])
    assert rc == 1


def test_cli_chunk_mode_matches_per_frame(tmp_path):
    """--chunk N (fused scan serving mode) produces the same trajectory."""
    seq = synthetic.generate_sequence(nb_frames=5, height=120, width=160, seed=7)
    assoc_path = tum_rgbd.write_sequence(str(tmp_path), seq.grays, seq.depths, seq.timestamps)

    def run(extra):
        buf = io.StringIO()
        with redirect_stdout(buf):
            rc = vors_track.main(
                ["fr1", assoc_path, "--nb-levels", "4", "--candidate-cap", "2048"]
                + extra
            )
        assert rc == 0
        return tum_rgbd.parse_trajectory(buf.getvalue())

    per_frame = run(["--no-bucket"])
    chunked = run(["--chunk", "2"])  # 4 tracked frames -> chunks of 2, 2
    assert len(chunked) == len(per_frame) == 4
    for a, b in zip(per_frame, chunked):
        assert a.timestamp == b.timestamp
        np.testing.assert_allclose(
            np.asarray(b.pose.t), np.asarray(a.pose.t), atol=2e-3
        )


def test_cli_batch_tracks_multiple_sequences(tmp_path):
    """vors_batch: two sequences of different lengths, per-sequence outputs."""
    from visual_odometry_rs_tpu.cli import vors_batch

    dirs = []
    seqs = []
    for i, nb in enumerate((5, 4)):
        seq = synthetic.generate_sequence(nb_frames=nb, height=120, width=160, seed=8 + i)
        d = tmp_path / f"seq{i}"
        d.mkdir()
        assoc = tum_rgbd.write_sequence(str(d), seq.grays, seq.depths, seq.timestamps)
        dirs.append(assoc)
        seqs.append(seq)

    out_dir = str(tmp_path / "trajs")
    rc = vors_batch.main(
        ["fr1", *dirs, "--out-dir", out_dir, "--nb-levels", "4",
         "--candidate-cap", "2048", "--chunk", "2"]
    )
    assert rc == 0
    import os

    names = sorted(os.listdir(out_dir))
    assert names == ["seq0.txt", "seq1.txt"]
    with open(os.path.join(out_dir, "seq0.txt")) as f:
        t0 = tum_rgbd.parse_trajectory(f.read())
    with open(os.path.join(out_dir, "seq1.txt")) as f:
        t1 = tum_rgbd.parse_trajectory(f.read())
    assert len(t0) == 4 and len(t1) == 3
    # per-sequence accuracy vs its own ground truth (same render recipe the
    # single-sequence CLI test uses)
    for frames, seq in ((t0, seqs[0]), (t1, seqs[1])):
        assert all(np.isfinite(np.asarray(f.pose.t)).all() for f in frames)


def test_cli_batch_sharded_over_mesh(tmp_path):
    """vors_batch with B == device count takes the data-sharded SPMD path."""
    from visual_odometry_rs_tpu.cli import vors_batch

    assocs = []
    for i in range(8):
        seq = synthetic.generate_sequence(nb_frames=3, height=48, width=64, seed=20 + i)
        d = tmp_path / f"s{i}"
        d.mkdir()
        assocs.append(
            tum_rgbd.write_sequence(str(d), seq.grays, seq.depths, seq.timestamps)
        )

    out_dir = str(tmp_path / "trajs")
    rc = vors_batch.main(
        ["fr1", *assocs, "--out-dir", out_dir, "--nb-levels", "3",
         "--candidate-cap", "256", "--chunk", "2"]
    )
    assert rc == 0
    import os

    assert len(os.listdir(out_dir)) == 8
    for name in os.listdir(out_dir):
        with open(os.path.join(out_dir, name)) as f:
            frames = tum_rgbd.parse_trajectory(f.read())
        assert len(frames) == 2
        assert all(np.isfinite(np.asarray(fr.pose.t)).all() for fr in frames)


def test_cli_refine_improves_or_preserves_trajectory(tmp_path):
    """vors_refine: track then refine; refined ATE stays within the
    photometric floor of the tracked ATE (and the plumbing round-trips)."""
    from visual_odometry_rs_tpu.cli import vors_refine
    from visual_odometry_rs_tpu.eval import ate

    seq = synthetic.generate_sequence(nb_frames=6, height=120, width=160, seed=9)
    assoc_path = tum_rgbd.write_sequence(str(tmp_path), seq.grays, seq.depths, seq.timestamps)

    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = vors_track.main(
            ["fr1", assoc_path, "--nb-levels", "4", "--candidate-cap", "2048"]
        )
    assert rc == 0
    traj_path = str(tmp_path / "traj.txt")
    with open(traj_path, "w") as f:
        f.write(buf.getvalue())

    buf2 = io.StringIO()
    with redirect_stdout(buf2):
        rc = vors_refine.main(
            ["fr1", assoc_path, traj_path, "--window", "3",
             "--nb-levels", "4", "--candidate-cap", "1024"]
        )
    assert rc == 0
    refined = tum_rgbd.parse_trajectory(buf2.getvalue())
    tracked = tum_rgbd.parse_trajectory(buf.getvalue())
    assert len(refined) == len(tracked) == 5

    gt = seq.poses[1:]
    ate_tracked = ate.ate_rmse([f.pose for f in tracked], gt)
    ate_refined = ate.ate_rmse([f.pose for f in refined], gt)
    # fr1 intrinsics on a rescaled render -> rough tracking; refinement must
    # not blow the trajectory up (bounded by tracked ATE + photometric floor)
    assert np.isfinite(ate_refined)
    assert ate_refined < ate_tracked + 0.02, (ate_tracked, ate_refined)


def test_cli_chunk_rejects_checkpoint_flags(tmp_path):
    seq = synthetic.generate_sequence(nb_frames=3, height=48, width=64, seed=1)
    assoc_path = tum_rgbd.write_sequence(str(tmp_path), seq.grays, seq.depths, seq.timestamps)
    rc = vors_track.main(
        ["fr1", assoc_path, "--chunk", "2", "--save-state", str(tmp_path / "ck.npz"),
         "--nb-levels", "3", "--candidate-cap", "256"]
    )
    assert rc == 1


def test_cli_chunk_metrics(tmp_path, capsys):
    seq = synthetic.generate_sequence(nb_frames=4, height=48, width=64, seed=2)
    assoc_path = tum_rgbd.write_sequence(str(tmp_path), seq.grays, seq.depths, seq.timestamps)
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = vors_track.main(
            ["fr1", assoc_path, "--chunk", "2", "--metrics",
             "--nb-levels", "3", "--candidate-cap", "256"]
        )
    assert rc == 0
    err = capsys.readouterr().err
    assert '"optical_flow"' in err and "session summary" in err.lower() or '"frame_index"' in err


def test_cli_batch_output_name_collision(tmp_path):
    """Two association files in one directory must not clobber each other."""
    from visual_odometry_rs_tpu.cli import vors_batch

    d = tmp_path / "seq"
    d.mkdir()
    seq = synthetic.generate_sequence(nb_frames=3, height=48, width=64, seed=3)
    a1 = tum_rgbd.write_sequence(str(d), seq.grays, seq.depths, seq.timestamps)
    # second associations file in the SAME directory referencing same images
    a2 = str(d / "associations2.txt")
    import shutil

    shutil.copy(a1, a2)
    out_dir = str(tmp_path / "trajs")
    rc = vors_batch.main(
        ["fr1", a1, a2, "--out-dir", out_dir, "--nb-levels", "3",
         "--candidate-cap", "256", "--chunk", "2"]
    )
    assert rc == 0
    import os

    names = sorted(os.listdir(out_dir))
    assert len(names) == 2, names
    for n in names:
        with open(os.path.join(out_dir, n)) as f:
            assert len(tum_rgbd.parse_trajectory(f.read())) == 2


def test_cli_interp_variants_agree(tmp_path):
    """--interp onehot_weighted (track) and --interp onehot (refine) run and
    stay within f32 rounding of the default gather paths."""
    from visual_odometry_rs_tpu.cli import vors_refine

    seq = synthetic.generate_sequence(nb_frames=3, height=48, width=64, seed=11)
    assoc_path = tum_rgbd.write_sequence(str(tmp_path), seq.grays, seq.depths, seq.timestamps)

    outs = {}
    for method in ("gather", "onehot_weighted"):
        buf = io.StringIO()
        with redirect_stdout(buf):
            rc = vors_track.main(
                ["fr1", assoc_path, "--nb-levels", "3", "--candidate-cap", "256",
                 "--interp", method]
            )
        assert rc == 0
        outs[method] = tum_rgbd.parse_trajectory(buf.getvalue())
    assert len(outs["gather"]) == len(outs["onehot_weighted"]) == 2
    for fg, fo in zip(outs["gather"], outs["onehot_weighted"]):
        np.testing.assert_allclose(
            np.asarray(fg.pose.t), np.asarray(fo.pose.t), atol=5e-3
        )

    traj_path = str(tmp_path / "traj.txt")
    with open(traj_path, "w") as f:
        f.write("\n".join(fr.to_string() for fr in outs["gather"]) + "\n")
    buf2 = io.StringIO()
    with redirect_stdout(buf2):
        rc = vors_refine.main(
            ["fr1", assoc_path, traj_path, "--window", "3", "--nb-levels", "3",
             "--candidate-cap", "128", "--max-iterations", "3",
             "--interp", "onehot"]
        )
    assert rc == 0
    refined = tum_rgbd.parse_trajectory(buf2.getvalue())
    assert len(refined) == 2
    assert all(np.isfinite(np.asarray(fr.pose.t)).all() for fr in refined)

def test_cli_refine_sliding_reduces_injected_drift(tmp_path):
    """vors_refine --mode sliding: a trajectory with injected cumulative
    drift must come back with strictly lower ATE (VERDICT round-1 item 7:
    no-op refinement must not pass silently)."""
    import jax.numpy as jnp

    from visual_odometry_rs_tpu.cli import vors_refine
    from visual_odometry_rs_tpu.eval import ate
    from visual_odometry_rs_tpu.math import se3

    seq = synthetic.generate_sequence(
        nb_frames=7, height=120, width=160, seed=31,
        motion_scale=0.012, rot_scale=0.003,
    )
    assoc_path = tum_rgbd.write_sequence(str(tmp_path), seq.grays, seq.depths, seq.timestamps)

    rng = np.random.default_rng(5)
    drift = [pose_mod.identity()]
    for _ in range(1, len(seq.poses)):
        step = se3.exp(jnp.asarray(rng.normal(size=6) * 0.004, jnp.float32))
        drift.append(pose_mod.compose(drift[-1], step))
    drifted = [pose_mod.compose(p, d) for p, d in zip(seq.poses, drift)]

    traj_path = str(tmp_path / "drifted.txt")
    with open(traj_path, "w") as f:
        for t, p in zip(seq.timestamps[1:], drifted[1:]):
            f.write(tum_rgbd.Frame(timestamp=float(t), pose=p).to_string() + "\n")

    ate_before = ate.ate_rmse(drifted[1:], seq.poses[1:])

    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = vors_refine.main(
            ["fr1", assoc_path, traj_path, "--mode", "sliding", "--window", "4",
             "--nb-levels", "3", "--candidate-cap", "1024", "--interp", "gather",
             "--energy-tol", "0.05"]
        )
    assert rc == 0
    refined = tum_rgbd.parse_trajectory(buf.getvalue())
    ate_after = ate.ate_rmse([f.pose for f in refined], seq.poses[1:])
    # the fr1 preset auto-rescales to the synthetic render's exact intrinsics
    assert ate_after < 0.6 * ate_before, (ate_before, ate_after)

def test_cli_slam_pipeline(tmp_path, capsys):
    """vors_slam: track -> loop-closure -> pose graph, end to end.

    An out-and-back trajectory revisits its start: the tracker must create
    keyframes, the front-end must verify at least one loop edge between
    them, and the optimized trajectory must stay at least as accurate as
    the tracked one."""
    from visual_odometry_rs_tpu.cli import vors_slam
    from visual_odometry_rs_tpu.eval import ate

    out = [[0.05, 0.004, 0.002, 0.002, -0.001, 0.001]] * 7
    back = [[-0.05, -0.004, -0.002, -0.002, 0.001, -0.001]] * 7
    twists = np.asarray(out + back, np.float32)
    seq = synthetic.generate_sequence(
        nb_frames=len(twists) + 1, height=120, width=160, seed=47,
        twist_per_frame=twists,
    )
    assoc_path = tum_rgbd.write_sequence(str(tmp_path), seq.grays, seq.depths, seq.timestamps)

    cloud_path = str(tmp_path / "map.ply")
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = vors_slam.main(
            ["fr1", assoc_path, "--nb-levels", "3", "--candidate-cap", "1024",
             "--loop-min-gap", "6", "--loop-radius", "0.35",
             "--loop-max-candidates", "4", "--export-cloud", cloud_path]
        )
    assert rc == 0
    err = capsys.readouterr().err
    frames = tum_rgbd.parse_trajectory(buf.getvalue())
    assert len(frames) == len(twists)
    assert all(np.isfinite(np.asarray(f.pose.t)).all() for f in frames)
    import re

    m = re.search(r"(\d+) keyframes, (\d+) verified loop edges", err)
    assert m, err
    nb_kf, nb_edges = int(m.group(1)), int(m.group(2))
    assert nb_kf >= 2, err
    assert nb_edges >= 1, err

    # run vors_track for the unoptimized comparison
    buf2 = io.StringIO()
    with redirect_stdout(buf2):
        rc = vors_track.main(
            ["fr1", assoc_path, "--nb-levels", "3", "--candidate-cap", "1024"]
        )
    assert rc == 0
    tracked = tum_rgbd.parse_trajectory(buf2.getvalue())
    gt = seq.poses[1:]
    ate_slam = ate.ate_rmse([f.pose for f in frames], gt)
    ate_track = ate.ate_rmse([f.pose for f in tracked], gt)
    # synthetic tracking is already near-exact; SLAM must not degrade it
    assert ate_slam <= ate_track + 2e-3, (ate_track, ate_slam)

    # --export-cloud wrote a non-empty finite sparse map
    from visual_odometry_rs_tpu.utils import pointcloud

    pts, inten = pointcloud.read_ply(cloud_path)
    assert len(pts) > nb_kf * 50
    assert np.isfinite(pts).all()
    assert f"exported {len(pts)} map points" in err

def test_cli_batch_switch_cadence(tmp_path):
    """--switch-cadence plumbs through to the batched scan driver."""
    from visual_odometry_rs_tpu.cli import vors_batch

    seq = synthetic.generate_sequence(nb_frames=4, height=48, width=64, seed=3)
    assoc = tum_rgbd.write_sequence(str(tmp_path), seq.grays, seq.depths, seq.timestamps)
    outdir = str(tmp_path / "out")
    rc = vors_batch.main(
        ["fr1", assoc, assoc, "--nb-levels", "3", "--candidate-cap", "256",
         "--out-dir", outdir, "--switch-cadence", "2"]
    )
    assert rc == 0
    import os

    for name in os.listdir(outdir):
        with open(os.path.join(outdir, name)) as f:
            frames = tum_rgbd.parse_trajectory(f.read())
        assert len(frames) == 3
        assert all(np.isfinite(np.asarray(fr.pose.t)).all() for fr in frames)


def test_cli_refine_save_resume_matches_uninterrupted(tmp_path):
    """vors_refine --save-state/--resume: an interrupted run resumed from
    its checkpoint must print the SAME refined trajectory as the
    uninterrupted run — including frames refined BEFORE the checkpoint
    (persisted in the checkpoint's extra channel), and without decoding
    the already-consumed frames.  Also covers extension-less checkpoint
    paths (atomic exact-path save)."""
    import jax.numpy as jnp

    from visual_odometry_rs_tpu.cli import vors_refine
    from visual_odometry_rs_tpu.math import se3

    seq = synthetic.generate_sequence(
        nb_frames=6, height=120, width=160, seed=31,
        motion_scale=0.012, rot_scale=0.003,
    )
    assoc_path = tum_rgbd.write_sequence(
        str(tmp_path), seq.grays, seq.depths, seq.timestamps
    )
    rng = np.random.default_rng(5)
    drift = [pose_mod.identity()]
    for _ in range(1, len(seq.poses)):
        step = se3.exp(jnp.asarray(rng.normal(size=6) * 0.004, jnp.float32))
        drift.append(pose_mod.compose(drift[-1], step))
    drifted = [pose_mod.compose(p, d) for p, d in zip(seq.poses, drift)]
    traj_path = str(tmp_path / "drifted.txt")
    with open(traj_path, "w") as f:
        for t, p in zip(seq.timestamps[1:], drifted[1:]):
            f.write(tum_rgbd.Frame(timestamp=float(t), pose=p).to_string() + "\n")

    cloud_full = str(tmp_path / "full.ply")
    cloud_res = str(tmp_path / "res.ply")
    common = ["fr1", assoc_path, traj_path, "--mode", "sliding", "--window", "3",
              "--nb-levels", "3", "--candidate-cap", "1024",
              "--interp", "gather", "--energy-tol", "0.05"]
    ckpt = str(tmp_path / "window.ckpt")  # extension-less on purpose

    # uninterrupted run, checkpointing every 3 frames (ckpt left at frame 3)
    buf_full = io.StringIO()
    with redirect_stdout(buf_full):
        rc = vors_refine.main(common + ["--save-state", ckpt, "--save-every", "3",
                                        "--export-cloud", cloud_full])
    assert rc == 0
    import os

    assert os.path.exists(ckpt)  # exact path, no silent .npz append

    # drop the final-save state: re-run first 3 frames only to recreate the
    # mid-run checkpoint, then resume
    buf_mid = io.StringIO()
    short_assoc = str(tmp_path / "short.txt")
    with open(assoc_path) as f:
        lines = [l for l in f.read().splitlines() if l.strip()]
    with open(short_assoc, "w") as f:
        # first line is the '#' header comment; keep 4 association lines
        # (frames 0..3) so the short run's state equals the full run's
        # state after its frame-3 checkpoint
        f.write("\n".join(lines[:5]) + "\n")
    short_traj = str(tmp_path / "short_traj.txt")
    with open(short_traj, "w") as f:
        for t, p in zip(seq.timestamps[1:4], drifted[1:4]):
            f.write(tum_rgbd.Frame(timestamp=float(t), pose=p).to_string() + "\n")
    with redirect_stdout(buf_mid):
        rc = vors_refine.main(
            ["fr1", short_assoc, short_traj, "--mode", "sliding", "--window", "3",
             "--nb-levels", "3", "--candidate-cap", "1024",
             "--interp", "gather", "--energy-tol", "0.05",
             "--save-state", ckpt, "--save-every", "3",
             "--export-cloud", str(tmp_path / "mid.ply")]
        )
    assert rc == 0

    buf_res = io.StringIO()
    with redirect_stdout(buf_res):
        rc = vors_refine.main(common + ["--resume", ckpt,
                                        "--export-cloud", cloud_res])
    assert rc == 0
    full = tum_rgbd.parse_trajectory(buf_full.getvalue())
    res = tum_rgbd.parse_trajectory(buf_res.getvalue())
    assert len(full) == len(res) == 5
    for a, b in zip(full, res):
        np.testing.assert_allclose(np.asarray(a.pose.t), np.asarray(b.pose.t),
                                   atol=1e-7)
        np.testing.assert_allclose(np.asarray(a.pose.q), np.asarray(b.pose.q),
                                   atol=1e-7)

    # the refined 3D map survives the resume: retired clouds ride in the
    # checkpoint, so the resumed export equals the uninterrupted one
    from visual_odometry_rs_tpu.utils import pointcloud

    pts_full, int_full = pointcloud.read_ply(cloud_full)
    pts_res, int_res = pointcloud.read_ply(cloud_res)
    assert len(pts_full) > 0
    np.testing.assert_allclose(pts_res, pts_full, atol=1e-5)
    np.testing.assert_array_equal(int_res, int_full)

    # mismatched resume must fail cleanly (different window size)
    rc = vors_refine.main(common[:6] + ["4"] + common[7:] + ["--resume", ckpt])
    assert rc == 1


def test_cli_resume_refusals(tmp_path, capsys):
    """Resume must refuse cleanly (exit 1, no traceback) on: a corrupt /
    non-npz checkpoint file (ValueError from np.load), and a checkpoint
    written for a DIFFERENT input sequence (config fingerprints match but
    consumed-frame timestamps don't); and vors_refine must reject
    --save-state/--resume outside sliding mode at argparse time."""
    import pytest

    from visual_odometry_rs_tpu.cli import vors_refine, vors_slam

    seq_a = synthetic.generate_sequence(
        nb_frames=4, height=120, width=160, seed=11,
        motion_scale=0.01, rot_scale=0.003,
    )
    # same camera/shape, different content AND different timestamps.
    # Timestamps are EPOCH-SCALE (~1.3e9 s, like real TUM data) with the
    # two sequences ~460 s apart: a relative-tolerance comparison
    # (np.allclose's default rtol=1e-5 = ~13,000 s of slack at this
    # magnitude) would wrongly accept the mismatch — the guard must
    # compare absolutely.
    seq_b = synthetic.generate_sequence(
        nb_frames=4, height=120, width=160, seed=12,
        motion_scale=0.01, rot_scale=0.003,
    )
    seq_a = seq_a._replace(timestamps=seq_a.timestamps + 1.3e9)
    seq_b = seq_b._replace(timestamps=seq_b.timestamps + 1.3e9 + 460.0)
    dir_a, dir_b = tmp_path / "a", tmp_path / "b"
    dir_a.mkdir(), dir_b.mkdir()
    assoc_a = tum_rgbd.write_sequence(
        str(dir_a), seq_a.grays, seq_a.depths, seq_a.timestamps
    )
    assoc_b = tum_rgbd.write_sequence(
        str(dir_b), seq_b.grays, seq_b.depths, seq_b.timestamps
    )

    def traj_file(seq, path):
        with open(path, "w") as f:
            for t, p in zip(seq.timestamps[1:], seq.poses[1:]):
                f.write(
                    tum_rgbd.Frame(timestamp=float(t), pose=p).to_string() + "\n"
                )
        return str(path)

    traj_a = traj_file(seq_a, tmp_path / "ta.txt")
    traj_b = traj_file(seq_b, tmp_path / "tb.txt")

    refine_opts = ["--mode", "sliding", "--window", "3", "--nb-levels", "3",
                   "--candidate-cap", "1024", "--interp", "gather"]
    ckpt = str(tmp_path / "w.npz")

    # flag misuse is an argparse error, not a silent no-op
    with pytest.raises(SystemExit):
        vors_refine.main(["fr1", assoc_a, traj_a, "--mode", "chunked",
                          "--save-state", ckpt])
    capsys.readouterr()

    # write a real checkpoint on sequence A
    rc = vors_refine.main(["fr1", assoc_a, traj_a, *refine_opts,
                           "--save-state", ckpt, "--save-every", "2"])
    assert rc == 0
    capsys.readouterr()

    # resume against sequence B: same config fingerprint, different data
    rc = vors_refine.main(["fr1", assoc_b, traj_b, *refine_opts,
                           "--resume", ckpt])
    assert rc == 1
    assert "different input sequence" in capsys.readouterr().err

    # corrupt checkpoint: clean refusal, not a traceback
    bad = tmp_path / "bad.npz"
    bad.write_text("this is not an npz file")
    rc = vors_refine.main(["fr1", assoc_a, traj_a, *refine_opts,
                           "--resume", str(bad)])
    assert rc == 1
    assert "Cannot resume" in capsys.readouterr().err

    # vors_slam: same two refusals
    slam_opts = ["--nb-levels", "3", "--candidate-cap", "1024",
                 "--interp", "gather", "--loop-min-gap", "1"]
    sck = str(tmp_path / "s.npz")
    rc = vors_slam.main(["fr1", assoc_a, *slam_opts,
                         "--save-state", sck, "--save-every", "2"])
    assert rc == 0
    capsys.readouterr()
    rc = vors_slam.main(["fr1", assoc_b, *slam_opts, "--resume", sck])
    assert rc == 1
    assert "different input sequence" in capsys.readouterr().err
    rc = vors_slam.main(["fr1", assoc_a, *slam_opts, "--resume", str(bad)])
    assert rc == 1
    assert "Cannot resume" in capsys.readouterr().err


def test_cli_batch_relocalize(tmp_path, capsys):
    """vors_batch --relocalize: a kidnapped sequence in the batch recovers
    in-graph (stderr notes the relocalization; the post-kidnap trajectory
    returns near ground truth)."""
    from visual_odometry_rs_tpu.cli import vors_batch

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
    dir_kid, dir_ok = tmp_path / "kid", tmp_path / "ok"
    dir_kid.mkdir(), dir_ok.mkdir()
    a_kid = tum_rgbd.write_sequence(
        str(dir_kid), seq_kid.grays, seq_kid.depths, seq_kid.timestamps
    )
    a_ok = tum_rgbd.write_sequence(
        str(dir_ok), seq_ok.grays, seq_ok.depths, seq_ok.timestamps
    )
    outdir = str(tmp_path / "out")
    rc = vors_batch.main(
        ["fr1", a_kid, a_ok, "--out-dir", outdir, "--nb-levels", "3",
         "--candidate-cap", "1024", "--interp", "gather", "--chunk", "3",
         "--relocalize", "4"]
    )
    assert rc == 0
    err = capsys.readouterr().err
    assert "Relocalized against keyframe ring" in err
    import os

    with open(os.path.join(outdir, "kid.txt")) as f:
        frames = tum_rgbd.parse_trajectory(f.read())
    assert len(frames) == len(twists)
    err_tail = float(np.linalg.norm(
        np.asarray(frames[-1].pose.t) - np.asarray(seq_kid.poses[-1].t)
    ))
    assert err_tail < 0.02, err_tail


def test_cli_slam_with_window_refinement(tmp_path, capsys):
    """vors_slam --refine-window: the complete DSO-style pipeline —
    tracking front-end, sliding-window photometric BA, loop closure on the
    REFINED poses, pose-graph optimization.  Must run end to end and stay
    at least as accurate as ground truth tracking allows."""
    from visual_odometry_rs_tpu.cli import vors_slam
    from visual_odometry_rs_tpu.eval import ate

    out = [[0.05, 0.004, 0.002, 0.002, -0.001, 0.001]] * 5
    back = [[-0.05, -0.004, -0.002, -0.002, 0.001, -0.001]] * 5
    twists = np.asarray(out + back, np.float32)
    seq = synthetic.generate_sequence(
        nb_frames=len(twists) + 1, height=120, width=160, seed=47,
        twist_per_frame=twists,
    )
    assoc_path = tum_rgbd.write_sequence(
        str(tmp_path), seq.grays, seq.depths, seq.timestamps
    )
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = vors_slam.main(
            ["fr1", assoc_path, "--nb-levels", "3", "--candidate-cap", "1024",
             "--interp", "gather", "--loop-min-gap", "5",
             "--loop-radius", "0.35", "--loop-max-candidates", "4",
             "--refine-window", "3", "--refine-energy-tol", "0.05"]
        )
    assert rc == 0
    err = capsys.readouterr().err
    assert "sliding-window refinement on" in err
    frames = tum_rgbd.parse_trajectory(buf.getvalue())
    assert len(frames) == len(twists)
    gt = seq.poses[1:]
    err_refined = ate.ate_rmse([f.pose for f in frames], gt)
    # refined SLAM stays within the photometric floor of this scene
    assert err_refined < 8e-3, err_refined

    # --save-state/--resume with --refine-window: the window state rides in
    # a sibling .window file; an interrupted run resumed mid-sequence must
    # print the IDENTICAL final trajectory
    common = ["fr1", assoc_path, "--nb-levels", "3", "--candidate-cap", "1024",
              "--interp", "gather", "--loop-min-gap", "5",
              "--loop-radius", "0.35", "--loop-max-candidates", "4",
              "--refine-window", "3", "--refine-energy-tol", "0.05"]
    ckpt = str(tmp_path / "s.ckpt")
    buf_full = io.StringIO()
    with redirect_stdout(buf_full):
        rc = vors_slam.main(common + ["--save-state", ckpt, "--save-every", "4"])
    assert rc == 0
    capsys.readouterr()
    import os

    assert os.path.exists(ckpt) and os.path.exists(ckpt + ".window")

    # the leftover checkpoint is the frame-8 state (save-every 4, 10
    # frames); resuming it must retrace frames 9-10 and reproduce the
    # uninterrupted trajectory exactly
    buf_res = io.StringIO()
    with redirect_stdout(buf_res):
        rc = vors_slam.main(common + ["--resume", ckpt])
    assert rc == 0
    assert "resumed from" in capsys.readouterr().err
    full = tum_rgbd.parse_trajectory(buf_full.getvalue())
    res = tum_rgbd.parse_trajectory(buf_res.getvalue())
    assert len(full) == len(res) == len(twists)
    for a, b in zip(full, res):
        np.testing.assert_allclose(np.asarray(a.pose.t), np.asarray(b.pose.t),
                                   atol=1e-7)


def test_cli_batch_save_resume_matches_uninterrupted(tmp_path):
    """vors_batch --save-state/--resume (VERDICT round-3 item 4): a run
    split with --max-frames + --resume produces byte-identical trajectories
    to the uninterrupted run, including cadence phase across the split (the
    frame_offset carry) and with the relocalization ring threaded through
    the checkpoint."""
    import os

    from visual_odometry_rs_tpu.cli import vors_batch

    dirs = []
    for i, nb in enumerate((7, 5)):  # different lengths: lane 1 finishes early
        seq = synthetic.generate_sequence(
            nb_frames=nb, height=120, width=160, seed=40 + i,
            motion_scale=0.01 + 0.01 * i,
        )
        d = tmp_path / f"seq{i}"
        d.mkdir()
        dirs.append(
            tum_rgbd.write_sequence(
                # distinct per-lane timestamps so the per-lane sequence
                # binding can actually tell the lanes apart
                str(d), seq.grays, seq.depths, seq.timestamps + 100.0 * i
            )
        )

    common = ["fr1", *dirs, "--nb-levels", "3", "--candidate-cap", "1024",
              "--chunk", "2", "--switch-cadence", "3", "--relocalize", "2"]

    out_full = str(tmp_path / "full")
    rc = vors_batch.main(common + ["--out-dir", out_full])
    assert rc == 0

    ckpt = str(tmp_path / "batch.ckpt")
    out_split = str(tmp_path / "split")
    rc = vors_batch.main(
        common + ["--out-dir", out_split, "--max-frames", "3",
                  "--save-state", ckpt]
    )
    assert rc == 0
    # simulate a crash between the output flush and save_checkpoint: a
    # stray line past the checkpoint must be trimmed on resume, not
    # duplicated by the append
    files = sorted(os.listdir(out_split))
    with open(os.path.join(out_split, files[0]), "a") as fh:
        fh.write("9999.0 0 0 0 0 0 0 1\n")
    rc = vors_batch.main(
        common + ["--out-dir", out_split, "--resume", ckpt]
    )
    assert rc == 0

    for name in sorted(os.listdir(out_full)):
        with open(os.path.join(out_full, name)) as f:
            want = f.read()
        with open(os.path.join(out_split, name)) as f:
            got = f.read()
        assert got == want, name

    # refusals: wrong cadence, wrong sequence, wrong reloc setting
    rc = vors_batch.main(
        ["fr1", *dirs, "--out-dir", str(tmp_path / "bad1"), "--nb-levels",
         "3", "--candidate-cap", "1024", "--chunk", "2", "--switch-cadence",
         "2", "--relocalize", "2", "--resume", ckpt]
    )
    assert rc == 1
    rc = vors_batch.main(
        ["fr1", dirs[1], dirs[0], "--out-dir", str(tmp_path / "bad3"),
         "--nb-levels", "3", "--candidate-cap", "1024", "--chunk", "2",
         "--switch-cadence", "3", "--relocalize", "2", "--resume", ckpt]
    )
    assert rc == 1  # lanes swapped: per-lane sequence binding refuses
    rc = vors_batch.main(
        ["fr1", *dirs, "--out-dir", str(tmp_path / "bad4"), "--nb-levels",
         "3", "--candidate-cap", "1024", "--chunk", "2", "--switch-cadence",
         "3", "--resume", ckpt]
    )
    assert rc == 1  # ring saved but --relocalize off: refused


def test_cli_slam_long_trajectory_bounded_memory(tmp_path):
    """Sequence-scale SLAM e2e (VERDICT round-3 item 5): an out-and-back
    trajectory whose every frame becomes a keyframe — 200+ keyframes through
    vors_slam with the disk keyframe store, spatial-hash loop proposal, and
    the sparse PGO back-end.  Asserts loop closures verify at scale and
    records wall time + peak RSS of the subprocess."""
    import resource
    import subprocess
    import sys as _sys
    import time

    h, w, F_half = 96, 128, 110
    # -x out, +x back: the return leg revisits outbound poses -> loops.
    # 0.1 m/frame keeps coarsest-level flow above the switch threshold for
    # the whole run (moving -x DECREASES the slanted plane's depth, so flow
    # grows along the leg), making nearly every frame a keyframe — the
    # retention stress case.
    twists = np.concatenate([
        np.tile([[-0.1, 0.0, 0.0, 0.0, 0.0, 0.0]], (F_half, 1)),
        np.tile([[0.1, 0.0, 0.0, 0.0, 0.0, 0.0]], (F_half, 1)),
    ]).astype(np.float32)
    seq = synthetic.generate_sequence(
        nb_frames=2 * F_half + 1, height=h, width=w, seed=77,
        twist_per_frame=twists,
    )
    assoc = tum_rgbd.write_sequence(str(tmp_path), seq.grays, seq.depths, seq.timestamps)

    before = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_sys.executable, "-m", "visual_odometry_rs_tpu.cli.vors_slam",
         "fr1", assoc, "--cpu", "--nb-levels", "3", "--candidate-cap", "512",
         "--kf-store", "disk", "--loop-min-gap", "20",
         "--loop-max-candidates", "8"],
        capture_output=True, text=True, timeout=3000,
        # the CLI caches compiled programs in the checkout by default
        env={**os.environ, "JAX_ENABLE_COMPILATION_CACHE": "false"},
    )
    wall = time.perf_counter() - t0
    after = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss
    # ru_maxrss(RUSAGE_CHILDREN) is a monotone max over ALL children: the
    # number is this subprocess's peak only if it set a new max; otherwise
    # an earlier (larger) child masks it and we can only report a bound
    peak_mb = after / 1024.0  # linux: KB
    peak_note = "" if after > before else " (<=: masked by an earlier child)"
    assert proc.returncode == 0, proc.stderr[-2000:]

    frames = tum_rgbd.parse_trajectory(proc.stdout)
    assert len(frames) == 2 * F_half
    import re

    m = re.search(r"(\d+) keyframes, (\d+) verified loop edges", proc.stderr)
    assert m, proc.stderr[-2000:]
    n_kf, n_edges = int(m.group(1)), int(m.group(2))
    assert n_kf >= 200, n_kf  # the retention stress premise held
    assert n_edges >= 1, proc.stderr[-2000:]
    assert "pose graph" in proc.stderr  # the (sparse, >64 nodes) PGO ran
    # optimized output must stay sane end to end
    est = [pose_mod.identity()] + [f.pose for f in frames]
    err = ate.ate_rmse(est, seq.poses)
    assert np.isfinite(err) and err < 1.0, err
    print(
        f"slam long-trajectory: {n_kf} keyframes, {n_edges} loop edges, "
        f"wall {wall:.1f}s, subprocess peak RSS {peak_mb:.0f} MB{peak_note}, "
        f"ATE {err:.4f}",
        file=_sys.stderr,
    )


def test_cli_slam_kf_store_modes_and_cross_mode_resume(tmp_path, capsys):
    """--kf-store disk (round 4, default) equals the resident memory mode
    end-to-end, and an image-free disk-mode checkpoint resumes correctly
    under --kf-store memory (the store re-decodes the consumed keyframes
    after the sequence binding passes)."""
    from visual_odometry_rs_tpu.cli import vors_slam

    seq = synthetic.generate_sequence(
        nb_frames=6, height=96, width=128, seed=31, motion_scale=0.02,
        rot_scale=0.005,
    )
    assoc = tum_rgbd.write_sequence(
        str(tmp_path), seq.grays, seq.depths, seq.timestamps
    )
    opts = ["--nb-levels", "3", "--candidate-cap", "512",
            "--interp", "gather", "--loop-min-gap", "1"]

    rc = vors_slam.main(["fr1", assoc, *opts, "--kf-store", "memory"])
    assert rc == 0
    out_mem = capsys.readouterr().out

    ckpt = str(tmp_path / "slam_disk.npz")
    rc = vors_slam.main(["fr1", assoc, *opts, "--kf-store", "disk",
                         "--save-state", ckpt])
    assert rc == 0
    out_disk = capsys.readouterr().out
    assert out_disk == out_mem  # retention mode cannot change results

    # resume the (image-free) disk checkpoint in memory mode: all frames
    # already tracked, so this replays loop closure + PGO from the store
    rc = vors_slam.main(["fr1", assoc, *opts, "--kf-store", "memory",
                         "--resume", ckpt])
    assert rc == 0
    err = capsys.readouterr()
    assert err.out == out_mem


def test_cli_batch_warm_start_velocity_save_resume(tmp_path):
    """vors_batch --warm-start constant_velocity: the velocity carry rides
    the checkpoint, so a split run is byte-identical to an uninterrupted
    one; resuming the same checkpoint without --warm-start is refused
    (config fingerprint pins the warm start)."""
    import os

    from visual_odometry_rs_tpu.cli import vors_batch

    dirs = []
    for i in range(2):
        seq = synthetic.generate_sequence(
            nb_frames=6, height=96, width=128, seed=50 + i,
            twist_per_frame=[0.01 + 0.01 * i, 0.0, 0.0, 0.0, 0.001, 0.0],
        )
        d = tmp_path / f"seq{i}"
        d.mkdir()
        dirs.append(
            tum_rgbd.write_sequence(
                str(d), seq.grays, seq.depths, seq.timestamps + 100.0 * i
            )
        )

    common = ["fr1", *dirs, "--nb-levels", "3", "--candidate-cap", "512",
              "--chunk", "2", "--warm-start", "constant_velocity"]

    out_full = str(tmp_path / "full")
    rc = vors_batch.main(common + ["--out-dir", out_full])
    assert rc == 0

    ckpt = str(tmp_path / "batch.ckpt")
    out_split = str(tmp_path / "split")
    rc = vors_batch.main(
        common + ["--out-dir", out_split, "--max-frames", "3",
                  "--save-state", ckpt]
    )
    assert rc == 0
    rc = vors_batch.main(common + ["--out-dir", out_split, "--resume", ckpt])
    assert rc == 0

    for name in sorted(os.listdir(out_full)):
        with open(os.path.join(out_full, name)) as f:
            want = f.read()
        with open(os.path.join(out_split, name)) as f:
            got = f.read()
        assert got == want, name
        assert len(want.splitlines()) == 5

    # refusal: same checkpoint, different warm start -> fingerprint mismatch
    rc = vors_batch.main(
        ["fr1", *dirs, "--out-dir", str(tmp_path / "bad"), "--nb-levels",
         "3", "--candidate-cap", "512", "--chunk", "2", "--resume", ckpt]
    )
    assert rc == 1


def _refine_batch_inputs(tmp_path, twists, nb_frames=6, h=96, w=128):
    """Render lanes, produce per-lane drifted input trajectories, return
    (pair list [(assoc, traj)...], gt poses per lane)."""
    import jax.numpy as jnp

    from visual_odometry_rs_tpu.math import se3

    pairs, gts = [], []
    rng = np.random.default_rng(7)
    for i, tw in enumerate(twists):
        seq = synthetic.generate_sequence(
            nb_frames=nb_frames, height=h, width=w, seed=60 + i,
            twist_per_frame=tw,
        )
        d = tmp_path / f"lane{i}"
        d.mkdir()
        assoc = tum_rgbd.write_sequence(
            str(d), seq.grays, seq.depths, seq.timestamps + 100.0 * i
        )
        # drifted init trajectory (what a tracker would hand to refinement)
        drift = pose_mod.identity()
        lines = []
        for f in range(1, nb_frames):
            drift = pose_mod.compose(
                drift,
                se3.exp(jnp.asarray(rng.normal(size=6) * 0.002, jnp.float32)),
            )
            p = pose_mod.compose(seq.poses[f], drift)
            lines.append(
                tum_rgbd.Frame(
                    timestamp=seq.timestamps[f] + 100.0 * i, pose=p
                ).to_string()
            )
        traj = str(d / "traj.txt")
        with open(traj, "w") as fh:
            fh.write("\n".join(lines) + "\n")
        pairs.append((assoc, traj))
        gts.append(seq.poses)
    return pairs, gts


def test_cli_refine_batch_matches_per_lane(tmp_path):
    """vors_refine --batch (round-5: the BatchedSlidingWindow product
    surface): per-lane outputs match single-sequence vors_refine runs lane
    for lane (vmap-lowering tolerance), and a run split with
    --save-state/--resume reproduces the uninterrupted batch exactly."""
    import os

    from visual_odometry_rs_tpu.cli import vors_refine

    pairs, _ = _refine_batch_inputs(
        tmp_path,
        [[0.004, 0.0, 0.0, 0.0, 0.0, 0.0], [0.03, 0.0, 0.0, 0.0, 0.0, 0.0]],
    )
    common = ["--window", "3", "--nb-levels", "3", "--candidate-cap", "512",
              "--max-iterations", "8", "--interp", "gather"]

    # single-lane references
    singles = []
    for assoc, traj in pairs:
        buf = io.StringIO()
        with redirect_stdout(buf):
            rc = vors_refine.main(["fr1", assoc, traj] + common)
        assert rc == 0
        singles.append(tum_rgbd.parse_trajectory(buf.getvalue()))

    # batched run
    out_dir = str(tmp_path / "batch_out")
    flat = [pairs[0][0], pairs[0][1], pairs[1][0], pairs[1][1]]
    rc = vors_refine.main(
        ["fr1", *flat, "--batch", "--out-dir", out_dir] + common
    )
    assert rc == 0
    names = sorted(os.listdir(out_dir))
    assert len(names) == 2
    for b, name in enumerate(names):
        with open(os.path.join(out_dir, name)) as f:
            got = tum_rgbd.parse_trajectory(f.read())
        want = singles[b]
        assert len(got) == len(want) == 5
        for fg, fw in zip(got, want):
            np.testing.assert_allclose(
                np.asarray(fg.pose.t), np.asarray(fw.pose.t), atol=3e-3,
                err_msg=name,
            )

    # split + resume == uninterrupted (byte-identical files): stop the
    # first run mid-sequence with --max-frames, resume finishes the rest
    ckpt = str(tmp_path / "bw.ckpt")
    out_split = str(tmp_path / "split_out")
    rc = vors_refine.main(
        ["fr1", *flat, "--batch", "--out-dir", out_split] + common
        + ["--save-state", ckpt, "--max-frames", "3"]
    )
    assert rc == 0
    rc = vors_refine.main(
        ["fr1", *flat, "--batch", "--out-dir", out_split] + common
        + ["--resume", ckpt]
    )
    assert rc == 0
    for name in names:
        with open(os.path.join(out_dir, name)) as f:
            want = f.read()
        with open(os.path.join(out_split, name)) as f:
            got = f.read()
        assert got == want, name

    # refusals: mismatched window geometry, swapped lanes
    rc = vors_refine.main(
        ["fr1", *flat, "--batch", "--out-dir", str(tmp_path / "bad1"),
         "--window", "4", "--nb-levels", "3", "--candidate-cap", "512",
         "--max-iterations", "8", "--interp", "gather", "--resume", ckpt]
    )
    assert rc == 1
    flat_swapped = [pairs[1][0], pairs[1][1], pairs[0][0], pairs[0][1]]
    rc = vors_refine.main(
        ["fr1", *flat_swapped, "--batch", "--out-dir", str(tmp_path / "bad2")]
        + common + ["--resume", ckpt]
    )
    assert rc == 1


def test_cli_slam_front_end_knobs(tmp_path):
    """vors_slam round-5 front-end knobs (warm start, level budgets,
    dso_fixed selector, Huber) plumb through to the tracking phase and
    keep the pipeline accurate on a smooth synthetic scene."""
    from visual_odometry_rs_tpu.cli import vors_slam
    from visual_odometry_rs_tpu.eval import ate

    seq = synthetic.generate_sequence(
        nb_frames=6, height=96, width=128, seed=48,
        twist_per_frame=[0.012, 0.004, 0.0, 0.002, 0.0, 0.001],
    )
    assoc_path = tum_rgbd.write_sequence(
        str(tmp_path), seq.grays, seq.depths, seq.timestamps
    )
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = vors_slam.main(
            ["fr1", assoc_path, "--nb-levels", "3", "--candidate-cap", "512",
             "--warm-start", "constant_velocity",
             "--level-iterations", "20,10,5",
             "--candidate-selector", "dso_fixed", "--dso-a", "0.2",
             "--robust-delta", "10.0"]
        )
    assert rc == 0
    frames = tum_rgbd.parse_trajectory(buf.getvalue())
    assert len(frames) == 5
    err = ate.ate_rmse([f.pose for f in frames], seq.poses[1:])
    assert err < 8e-3, err


@pytest.mark.parametrize("case", ["env", "flag", "default"])
def test_compilation_cache_dir(case, tmp_path, monkeypatch):
    """One helper places the persistent compile cache for every entry
    point: JAX_COMPILATION_CACHE_DIR wins and nothing is set; otherwise
    --compilation-cache; otherwise the fixed <checkout>/.jax_cache."""
    import argparse
    import pathlib

    import jax

    from visual_odometry_rs_tpu.cli import _common

    before = jax.config.jax_compilation_cache_dir
    flag = str(tmp_path / "flag")
    args = argparse.Namespace(compilation_cache=flag if case != "default" else None)
    try:
        if case == "env":
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
            assert _common.enable_compilation_cache(flag) == str(tmp_path / "env")
            _common.apply_compilation_cache(args)
            assert jax.config.jax_compilation_cache_dir == before
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            _common.apply_compilation_cache(args)
            want = flag if case == "flag" else _common.DEFAULT_CACHE_DIR
            assert jax.config.jax_compilation_cache_dir == want
        checkout = pathlib.Path(_common.__file__).resolve().parents[2]
        assert _common.DEFAULT_CACHE_DIR == str(checkout / ".jax_cache")
        assert ".jax_cache/" in (checkout / ".gitignore").read_text().split()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
