"""GPU smoke test: the tracker's main path end to end on one card.

    python chip_smoke.py              # one GPU: every phase below
    python chip_smoke.py --cards 4    # four GPUs: the sharded paths only

Renders synthetic TUM-layout RGB-D sequences at 640x480 (u16 depth at
5000/m, fr1 intrinsics), then in ONE process (a second JAX process would
find the card's memory taken):

  (a) ``vors_track`` streaming, default flags: ATE < 0.02 m, >= 1 switch
  (b) ``vors_track --chunk 10``: same ATE bound, poses within 1e-2 m of (a)
  (c) ``vors_batch`` over 8 lanes: every lane's ATE < 0.02 m
  (d) ``vors_refine`` on (a)'s trajectory: finite ATE < 0.02 m

then checks the one-hot formulations against their plain references at
real widths, and runs ``track_frame``, one photometric window solve and one
pose-graph solve on the GPU (default and "highest" matmul precision) and on
the host CPU, comparing the three.  Every CLI phase runs twice: the first
wall time includes compilation, the second gives frames/s.

Any failed check exits nonzero.  On success the last line of stdout is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Without a GPU the script exits 1 before doing any work.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

H, W = 480, 640  # TUM RGB-D frame size
ATE_BOUND = 0.02  # m, synthetic-ground-truth accuracy bound of every phase
# the LM stop test is discrete: two compiled programs (streaming vs fused
# scan, one card vs four) may stop after different iteration counts
POSE_AGREE = 1e-2  # m


class CheckFailed(Exception):
    pass


def check(ok: bool, what: str) -> None:
    print(f"  {'ok  ' if ok else 'FAIL'} {what}", flush=True)
    if not ok:
        raise CheckFailed(what)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def render_main_sequence(h=H, w=W, nb_frames=30):
    """Smooth handheld-like motion (1 cm and 2 mrad per frame) whose
    optical flow crosses the switch threshold every few frames."""
    return render(h, w, nb_frames, seed=42, magnitude=0.01, rotation=0.002)


def render_lanes(h=H, w=W, n_lanes=8, nb_frames=11):
    """Diverse lanes: a motion-magnitude ladder (4 to 40 mm per frame),
    per-lane direction, rotation and texture, so keyframe switches fall on
    different frames."""
    return [
        render(h, w, nb_frames, seed=100 + lane,
               magnitude=0.004 + 0.036 * lane / max(1, n_lanes - 1), rotation=0.002)
        for lane in range(n_lanes)
    ]


def render(h, w, nb_frames, seed, magnitude, rotation):
    """Constant-twist sequence: a random direction at ``magnitude`` m per
    frame plus a random rotation of scale ``rotation`` rad per frame."""
    from visual_odometry_rs_tpu.dataset import synthetic

    rng = np.random.default_rng(seed)
    direction = rng.normal(size=3)
    twist = np.concatenate(
        [magnitude * direction / np.linalg.norm(direction), rotation * rng.normal(size=3)]
    )
    return synthetic.generate_sequence(
        nb_frames=nb_frames, height=h, width=w, seed=seed, twist_per_frame=twist
    )


def write(seq, directory):
    from visual_odometry_rs_tpu.dataset import tum_rgbd

    return tum_rgbd.write_sequence(directory, seq.grays, seq.depths, seq.timestamps)


def ate_of(text, seq):
    """ATE (m) of a TUM trajectory (one line per frame after the first)."""
    from visual_odometry_rs_tpu.dataset import tum_rgbd
    from visual_odometry_rs_tpu.eval import ate
    from visual_odometry_rs_tpu.math import pose as pose_mod

    frames = tum_rgbd.parse_trajectory(text)
    if len(frames) != len(seq.poses) - 1:
        raise CheckFailed(f"{len(frames)} trajectory lines for {len(seq.poses)} frames")
    est = [pose_mod.identity()] + [f.pose for f in frames]
    positions = np.stack([np.asarray(p.t) for p in est])
    return ate.ate_rmse(est, seq.poses), positions


def run_cli(main, argv, label):
    """Call a CLI ``main(argv)`` in-process; returns (stdout, stderr, s)."""
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    seconds = time.perf_counter() - t0
    if rc != 0:
        print(err.getvalue()[-3000:], file=sys.stderr)
        raise CheckFailed(f"{label} exited {rc}")
    return out.getvalue(), err.getvalue(), seconds


def run_cli_twice(main, argv, label, frames):
    """Cold (compile-inclusive) then warm run; prints the timing line."""
    out, err, cold = run_cli(main, argv, label)
    out, err, warm = run_cli(main, argv, label)
    print(
        f"  {label}: {frames} frames, compile-inclusive wall {cold:.3f} s, "
        f"warm wall {warm:.3f} s = {frames / warm:.2f} frames/s, "
        f"{1e3 * warm / frames:.2f} ms/frame", flush=True,
    )
    return out, err


# ---------------------------------------------------------------------------
# CLI phases
# ---------------------------------------------------------------------------


def phase_track(assoc, seq):
    """(a) streaming vors_track and (b) its fused --chunk mode."""
    from visual_odometry_rs_tpu.cli import vors_track

    n = len(seq.poses) - 1
    print("(a) vors_track, streaming, default flags", flush=True)
    out_a, err_a = run_cli_twice(vors_track.main, ["fr1", assoc], "vors_track", n)
    ate_a, pos_a = ate_of(out_a, seq)
    flows = [float(l.split()[-1]) for l in err_a.splitlines() if l.startswith("Optical_flow:")]
    switches = sum(f >= 1.0 for f in flows)  # the tracker's switch criterion
    print(f"  ATE {ate_a:.6f} m, {switches} keyframe switches", flush=True)
    check(ate_a < ATE_BOUND, f"(a) ATE {ate_a:.6f} < {ATE_BOUND}")
    check(switches >= 1, f"(a) {switches} keyframe switches >= 1")

    print("(b) vors_track --chunk 10", flush=True)
    out_b, _ = run_cli_twice(
        vors_track.main, ["fr1", assoc, "--chunk", "10"], "vors_track --chunk 10", n
    )
    ate_b, pos_b = ate_of(out_b, seq)
    diff = float(np.abs(pos_a - pos_b).max())
    print(f"  ATE {ate_b:.6f} m, max |pose(a) - pose(b)| {diff:.3e} m", flush=True)
    check(ate_b < ATE_BOUND, f"(b) ATE {ate_b:.6f} < {ATE_BOUND}")
    check(diff < POSE_AGREE, f"(b) poses agree with (a) within {POSE_AGREE} m")
    return out_a


def batch_lanes(assocs, seqs, out_dir, extra=(), timed=True):
    """vors_batch over the lanes; returns per-lane (ATE, positions).
    ``timed`` adds the warm second run that gives frames/s."""
    from visual_odometry_rs_tpu.cli import vors_batch

    argv = ["fr1", *assocs, "--out-dir", out_dir, *extra]
    label = f"vors_batch {' '.join(extra)}".strip()
    frames = sum(len(s.poses) - 1 for s in seqs)
    if timed:
        run_cli_twice(vors_batch.main, argv, label, frames)
    else:
        seconds = run_cli(vors_batch.main, argv, label)[2]
        print(f"  {label}: {frames} frames, compile-inclusive wall {seconds:.3f} s", flush=True)
    results = []
    for assoc, seq in zip(assocs, seqs):
        name = os.path.basename(os.path.dirname(assoc)) + ".txt"
        with open(os.path.join(out_dir, name)) as f:
            results.append(ate_of(f.read(), seq))
    return results


def phase_batch(assocs, seqs, out_dir):
    print(f"(c) vors_batch, {len(assocs)} lanes", flush=True)
    results = batch_lanes(assocs, seqs, out_dir)
    for b, (err, _) in enumerate(results):
        check(err < ATE_BOUND, f"(c) lane {b} ATE {err:.6f} < {ATE_BOUND}")


def phase_refine(assoc, seq, traj_text, workdir):
    from visual_odometry_rs_tpu.cli import vors_refine

    print("(d) vors_refine on (a)'s trajectory", flush=True)
    traj = os.path.join(workdir, "track_a.txt")
    with open(traj, "w") as f:
        f.write(traj_text)
    n = len(seq.poses) - 1
    out, _ = run_cli_twice(vors_refine.main, ["fr1", assoc, traj], "vors_refine", n)
    err, _ = ate_of(out, seq)
    print(f"  refined ATE {err:.6f} m", flush=True)
    check(bool(np.isfinite(err)) and err < ATE_BOUND, f"(d) refined ATE {err:.6f} < {ATE_BOUND}")


# ---------------------------------------------------------------------------
# exactness of the one-hot formulations against plain references
# ---------------------------------------------------------------------------


def check_samplers(h=H, w=W, n=4096, seed=0):
    """One-hot samplers vs ``bilinear_gather`` on a u8 level, with points
    inside and outside the image.  Masks must be equal; values agree within
    1e-3 because the sums are reassociated in f32 over values up to 255."""
    import jax
    import jax.numpy as jnp

    from visual_odometry_rs_tpu.ops import interp

    rng = np.random.default_rng(seed)
    img = jnp.asarray(rng.integers(0, 256, (h, w), dtype=np.uint8))
    x = jnp.asarray(rng.uniform(-8.0, w + 8.0, n).astype(np.float32))
    y = jnp.asarray(rng.uniform(-8.0, h + 8.0, n).astype(np.float32))
    ref_v, ref_m = jax.jit(interp.bilinear_gather)(img, x, y)
    ref_v, ref_m = np.asarray(ref_v), np.asarray(ref_m)
    inside = int(ref_m.sum())
    check(0 < inside < n, f"samplers: {inside}/{n} points inside the image")
    for name in ("bilinear_onehot", "bilinear_onehot_weighted"):
        v, m = jax.jit(getattr(interp, name))(img, x, y)
        v, m = np.asarray(v), np.asarray(m)
        err = float(np.abs(v - ref_v).max())
        check(np.array_equal(m, ref_m), f"{name}: mask equals gather's ({h}x{w}, N={n})")
        check(err <= 1e-3, f"{name}: max |value - gather| {err:.2e} <= 1e-3")


def check_extraction(depth, gray, nb_levels=6, cap=8192):
    """``_extract_level_onehot`` vs the plain ``_extract_candidates`` at every
    pyramid level of one keyframe, with no truncation (points <= cap).
    The (x, y, idepth) sets sorted by pixel index must be equal, and the
    gradient/template channels must equal plain indexing, exactly."""
    import jax
    import jax.numpy as jnp

    from visual_odometry_rs_tpu.core import inverse_depth as idepth_mod
    from visual_odometry_rs_tpu.core.candidates import coarse_to_fine
    from visual_odometry_rs_tpu.models import tracker as tracker_mod
    from visual_odometry_rs_tpu.ops import gradient as gradient_ops
    from visual_odometry_rs_tpu.ops import pyramid as pyramid_ops

    h, w = gray.shape
    config = tracker_mod.TrackerConfig(height=h, width=w, nb_levels=nb_levels)

    @jax.jit
    def keyframe(depth, gray):
        pyr = pyramid_ops.mean_pyramid(nb_levels, gray)
        grads = tracker_mod._keyframe_gradients(pyr)
        sqn = [gradient_ops.squared_norm_f32(gx, gy) for gx, gy in grads]
        mask = coarse_to_fine.select(config.candidates_diff_threshold, sqn)[-1]
        id0 = idepth_mod.masked(
            idepth_mod.from_depth(config.depth_scale, depth, config.idepth_variance),
            mask,
        )
        return pyr, grads, idepth_mod.pyramid(id0, nb_levels, strategy="dso_mean")

    pyr, grads, id_levels = keyframe(jnp.asarray(depth), jnp.asarray(gray))
    for lvl in range(nb_levels):
        idmap = id_levels[lvl]
        gx, gy = grads[lvl]
        lh, lw = idmap.state.shape
        count = int(np.asarray(idmap.known).sum())
        cap_l = min(cap, lh * lw)
        check(0 < count <= cap_l, f"extraction level {lvl}: {count} points <= cap {cap_l}")
        d16 = jnp.asarray(depth) if lvl == 0 else None
        onehot = jax.jit(
            lambda m, gx, gy, t, d: tracker_mod._extract_level_onehot(
                m, gx, gy, t, cap_l, depth_u16=d, depth_scale=config.depth_scale
            )
        )(idmap, gx, gy, pyr[lvl], d16)
        plain = jax.jit(lambda m: tracker_mod._extract_candidates(m, cap_l))(idmap)
        xs, ys, z, valid, gu, gv, tv = (np.asarray(a) for a in onehot)
        pxs, pys, pz, pvalid = (np.asarray(a) for a in plain)

        def by_pixel(xs, ys, valid, *chans):
            xi, yi = xs[valid].astype(np.int64), ys[valid].astype(np.int64)
            order = np.argsort(yi * lw + xi)
            return (xi[order], yi[order]) + tuple(c[valid][order] for c in chans)

        ox, oy, oz, ogu, ogv, otv = by_pixel(xs, ys, valid, z, gu, gv, tv)
        px, py, pzz = by_pixel(pxs, pys, pvalid, pz)
        same = (
            valid.sum() == pvalid.sum() == count
            and np.array_equal(ox, px) and np.array_equal(oy, py)
            and np.array_equal(oz.view(np.uint32), pzz.view(np.uint32))
        )
        check(same, f"extraction level {lvl}: (x, y, idepth) sets equal ({count} points)")
        chans_ok = (
            np.array_equal(ogu, np.asarray(gx)[oy, ox])
            and np.array_equal(ogv, np.asarray(gy)[oy, ox])
            and np.array_equal(otv, np.asarray(pyr[lvl]).astype(np.float32)[oy, ox])
        )
        check(chans_ok, f"extraction level {lvl}: gradient/template channels exact")


def check_lane_moves(n_lanes=32, k_sub=8, row_shape=(4096, 7), seed=0):
    """``_onehot_rows`` vs ``jnp.take`` on f32 lanes holding NaN and inf bit
    patterns: the moved lanes must be bit-equal."""
    import jax
    import jax.numpy as jnp

    from visual_odometry_rs_tpu.parallel import batch as batch_mod

    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2**32, (n_lanes,) + row_shape, dtype=np.uint64).astype(np.uint32)
    specials = np.array(
        [0x7FC00000, 0x7FC00001, 0xFFC12345, 0x7F800001, 0x7F800000, 0xFF800000, 0x80000000],
        np.uint32,
    )
    flat = bits.reshape(-1)
    flat[rng.choice(flat.size, 64 * len(specials), replace=False)] = np.repeat(specials, 64)
    x = bits.view(np.float32)
    # fewer pending lanes than slots, so some selector rows are empty
    pending = np.zeros(n_lanes, bool)
    pending[rng.choice(n_lanes, k_sub - 2, replace=False)] = True
    sel = np.asarray(batch_mod._lane_onehot(jnp.asarray(pending), k_sub))
    got = np.asarray(jax.jit(batch_mod._onehot_rows)(jnp.asarray(sel), jnp.asarray(x)))
    idx = sel.argmax(axis=1)
    want = np.asarray(jax.jit(lambda a, i: jnp.take(a, i, axis=0))(jnp.asarray(x), jnp.asarray(idx)))
    want = np.where(sel.any(axis=1).reshape((-1,) + (1,) * len(row_shape)), want, np.float32(0))
    check(
        np.array_equal(got.view(np.uint32), want.view(np.uint32)),
        f"_onehot_rows: {k_sub} of {n_lanes} lanes x {row_shape} bit-equal to take",
    )


# ---------------------------------------------------------------------------
# the same solves on the GPU and on the host CPU
# ---------------------------------------------------------------------------


def _intr_floats(intrinsics):
    return tuple(float(v) for v in intrinsics)


def track_five(seq, cap=4096, nb_levels=6):
    """Builds fn(depth0, gray0, grays) -> (F, 7) poses [t | q] of a 5-frame
    track against frame 0's keyframe, each frame started from the last."""
    import jax
    import jax.numpy as jnp

    from visual_odometry_rs_tpu.core.camera import Intrinsics
    from visual_odometry_rs_tpu.math import pose as pose_mod
    from visual_odometry_rs_tpu.models import tracker as tracker_mod
    from visual_odometry_rs_tpu.ops import pyramid as pyramid_ops

    h, w = seq.grays.shape[1:]
    config = tracker_mod.TrackerConfig(height=h, width=w, nb_levels=nb_levels, candidate_cap=cap)
    k = _intr_floats(seq.intrinsics)

    @jax.jit
    def fn(depth0, gray0, grays):
        intr = Intrinsics.make(*k)
        pyr0 = pyramid_ops.mean_pyramid(nb_levels, gray0)
        kf = tracker_mod.precompute_keyframe(config, intr, depth0, pyr0)
        model, out = pose_mod.identity(), []
        for f in range(grays.shape[0]):
            pyr = pyramid_ops.mean_pyramid(nb_levels, grays[f])
            model = tracker_mod.track_frame(config, kf, pyr, model).model
            out.append(jnp.concatenate([model.t, model.q]))
        return jnp.stack(out)

    return fn, (seq.depths[0], seq.grays[0], seq.grays[1:6])


def window_solve(seq, cap=2048, nb_levels=6, frames=6):
    """Builds fn(depth0, gray0, images, q, t) -> (F, 7) refined window poses,
    from ground truth perturbed by a deterministic ~1 cm / 5 mrad offset."""
    import jax
    import jax.numpy as jnp

    from visual_odometry_rs_tpu.core.camera import Intrinsics
    from visual_odometry_rs_tpu.math import pose as pose_mod
    from visual_odometry_rs_tpu.math import se3
    from visual_odometry_rs_tpu.math.pose import Pose
    from visual_odometry_rs_tpu.models import photometric_ba
    from visual_odometry_rs_tpu.models import tracker as tracker_mod
    from visual_odometry_rs_tpu.ops import pyramid as pyramid_ops

    h, w = seq.grays.shape[1:]
    config = tracker_mod.TrackerConfig(height=h, width=w, nb_levels=nb_levels, candidate_cap=cap)
    k = _intr_floats(seq.intrinsics)
    rng = np.random.default_rng(7)
    rel_q, rel_t = [], []
    for i in range(frames):
        # keyframe -> frame i motion (the tracker's model convention)
        rel = pose_mod.compose(pose_mod.inverse(seq.poses[i]), seq.poses[0])
        if i:
            noise = np.concatenate([0.01 * rng.normal(size=3), 0.005 * rng.normal(size=3)])
            rel = pose_mod.compose(rel, se3.exp(jnp.asarray(noise, jnp.float32)))
        rel_q.append(np.asarray(rel.q))
        rel_t.append(np.asarray(rel.t))

    @jax.jit
    def fn(depth0, gray0, images, q, t):
        intr = Intrinsics.make(*k)
        pyr0 = pyramid_ops.mean_pyramid(nb_levels, gray0)
        kf = tracker_mod.precompute_keyframe(config, intr, depth0, pyr0)
        win = photometric_ba.window_from_tracking(
            config, intr, kf.levels, images.astype(jnp.float32), Pose(q, t)
        )
        res = photometric_ba.solve_window(win, energy_tol=1.0)
        return jnp.concatenate([res.poses.t, res.poses.q], axis=1)

    return fn, (seq.depths[0], seq.grays[0], seq.grays[:frames], np.stack(rel_q), np.stack(rel_t))


def pose_graph_solve(n_nodes=40, seed=3):
    """Builds fn(q, t, loop_q, loop_t) -> (N, 7) optimized nodes of a noisy
    odometry chain closed by one loop edge (dense LM solve)."""
    import jax
    import jax.numpy as jnp

    from visual_odometry_rs_tpu.math import pose as pose_mod
    from visual_odometry_rs_tpu.math import se3
    from visual_odometry_rs_tpu.math.pose import Pose
    from visual_odometry_rs_tpu.parallel import pose_graph

    rng = np.random.default_rng(seed)
    ideal = np.array([0.1, 0.0, 0.0, 0.0, 2 * np.pi / n_nodes, 0.0])
    true_end, nodes = pose_mod.identity(), [pose_mod.identity()]
    for _ in range(1, n_nodes):
        noise = np.concatenate([0.003 * rng.normal(size=3), 0.002 * rng.normal(size=3)])
        nodes.append(pose_mod.compose(nodes[-1], se3.exp(jnp.asarray(ideal + noise, jnp.float32))))
        true_end = pose_mod.compose(true_end, se3.exp(jnp.asarray(ideal, jnp.float32)))
    q = np.stack([np.asarray(p.q) for p in nodes])
    t = np.stack([np.asarray(p.t) for p in nodes])
    loop = true_end  # measured node 0 -> node N-1 motion, free of the drift

    @jax.jit
    def fn(q, t, lq, lt):
        graph = pose_graph.odometry_graph(Pose(q, t), loop_edges=[(0, n_nodes - 1, Pose(lq, lt))])
        res = pose_graph.solve(graph)
        return jnp.concatenate([res.nodes.t, res.nodes.q], axis=1)

    return fn, (q, t, np.asarray(loop.q), np.asarray(loop.t))


def compare_backends(name, make, tol, cpu):
    """Run ``make()``'s function on the GPU at default and at "highest"
    matmul precision and on the CPU; the GPU default must match the CPU."""
    import jax

    fn, args = make()
    runs = {}
    for label in ("gpu default", "gpu highest", "cpu"):
        device = cpu if label == "cpu" else jax.devices()[0]
        precision = "highest" if label == "gpu highest" else None
        with jax.default_device(device), jax.default_matmul_precision(precision):
            out = np.asarray(fn(*[np.asarray(a) for a in args]))
        check(bool(np.isfinite(out).all()), f"{name} on {label}: finite")
        runs[label] = out
    d_default = float(np.abs(runs["gpu default"] - runs["cpu"]).max())
    d_highest = float(np.abs(runs["gpu highest"] - runs["cpu"]).max())
    d_gpu = float(np.abs(runs["gpu default"] - runs["gpu highest"]).max())
    print(
        f"  {name}: max |gpu default - cpu| {d_default:.3e}, "
        f"|gpu highest - cpu| {d_highest:.3e}, |gpu default - gpu highest| {d_gpu:.3e}",
        flush=True,
    )
    check(d_default <= tol, f"{name}: gpu default within {tol} of cpu")


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------


def check_lane_placement(seqs, n_cards):
    """The batched state of the fused scan lands on ``n_cards`` distinct
    devices, an equal share of lanes on each."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from visual_odometry_rs_tpu.models import tracker as tracker_mod
    from visual_odometry_rs_tpu.parallel import batch as batch_mod
    from visual_odometry_rs_tpu.parallel import mesh as mesh_mod

    h, w = seqs[0].grays.shape[1:]
    B = len(seqs)
    config = tracker_mod.TrackerConfig(height=h, width=w, nb_levels=6, candidate_cap=8192)
    intr = seqs[0].intrinsics
    mesh = mesh_mod.make_mesh((n_cards,), ("data",), jax.local_devices()[:n_cards])
    d0 = np.stack([s.depths[0] for s in seqs])
    g0 = np.stack([s.grays[0] for s in seqs])
    state = jax.jit(lambda d, g: batch_mod.batched_init_state(config, intr, d, g))(d0, g0)
    state = mesh_mod.shard_batch(state, mesh)
    clip = NamedSharding(mesh, P(None, "data"))
    dd = jax.device_put(np.stack([s.depths[1:3] for s in seqs], axis=1), clip)
    gg = jax.device_put(np.stack([s.grays[1:3] for s in seqs], axis=1), clip)
    final, _ = jax.jit(
        lambda s, d, g: batch_mod.batched_track_sequence(config, intr, s, d, g)
    )(state, dd, gg)
    shards = final.current_pose.t.addressable_shards
    devices = {s.device for s in shards}
    lanes = sorted(int(s.data.shape[0]) for s in shards)
    print(f"  lane state shards: {[(str(s.device), s.data.shape[0]) for s in shards]}", flush=True)
    check(
        len(devices) == n_cards and lanes == [B // n_cards] * n_cards,
        f"lane state on {len(devices)} distinct devices, {B // n_cards} lanes each",
    )


def check_sharded_solves(seq, n_cards):
    """Ring all-reduce, candidate-sharded window, point-sharded LM and
    edge-sharded PGO on ``n_cards`` devices, each against its one-device
    counterpart."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from visual_odometry_rs_tpu.math import pose as pose_mod
    from visual_odometry_rs_tpu.math.pose import Pose
    from visual_odometry_rs_tpu.models import photometric_ba
    from visual_odometry_rs_tpu.models import tracker as tracker_mod
    from visual_odometry_rs_tpu.ops import pyramid as pyramid_ops
    from visual_odometry_rs_tpu.parallel import collectives, mesh as mesh_mod
    from visual_odometry_rs_tpu.parallel import pose_graph, sharded

    devices = jax.local_devices()[:n_cards]

    ring = mesh_mod.make_mesh((n_cards,), ("x",), devices)
    x = jnp.asarray(
        np.random.default_rng(0).normal(size=(n_cards, n_cards * 1024, 6)).astype(np.float32)
    )
    got = jax.jit(jax.shard_map(
        lambda xl: collectives.ring_all_reduce(xl[0], "x", n_cards)[None],
        mesh=ring, in_specs=(P("x", None, None),), out_specs=P("x", None, None),
    ))(x)
    want = np.asarray(x).sum(axis=0)
    err = float(np.abs(np.asarray(got) - want[None]).max())
    # f32 sums of n_cards N(0,1) terms in another order: ~1e-6 relative
    check(err < 1e-4, f"ring all-reduce on {n_cards} cards: max error {err:.2e} < 1e-4")

    h, w = seq.grays.shape[1:]
    config = tracker_mod.TrackerConfig(height=h, width=w, nb_levels=6, candidate_cap=4096)
    pyr0 = pyramid_ops.mean_pyramid(6, jnp.asarray(seq.grays[0]))
    kf = jax.jit(
        lambda d, p: tracker_mod.precompute_keyframe(config, seq.intrinsics, d, p)
    )(jnp.asarray(seq.depths[0]), pyr0)

    points = mesh_mod.make_mesh((n_cards,), ("points",), devices)
    rel = [pose_mod.compose(pose_mod.inverse(seq.poses[i]), seq.poses[0]) for i in range(4)]
    win = photometric_ba.window_from_tracking(
        config, seq.intrinsics, kf.levels,
        jnp.asarray(seq.grays[:4]).astype(jnp.float32),
        Pose(jnp.stack([p.q for p in rel]), jnp.stack([p.t for p in rel])),
    )
    one = jax.jit(lambda wn: photometric_ba.solve_window(wn, energy_tol=1.0))(win)
    many = jax.jit(
        lambda wn: photometric_ba.solve_window_sharded(wn, points, energy_tol=1.0)
    )(win)
    err = float(np.abs(np.asarray(one.poses.t) - np.asarray(many.poses.t)).max())
    check(err < 1e-3, f"candidate-sharded window solve: max |dt| {err:.2e} m < 1e-3")

    obs = kf.levels[0]
    img1 = jnp.asarray(seq.grays[1])
    m0 = pose_mod.identity()
    one = jax.jit(lambda o, i, m: tracker_mod.solve_level(o, i, m))(obs, img1, m0)
    with points:
        model, failed, _ = jax.jit(
            lambda o, i, m: sharded.solve_level_point_sharded(o, i, m, points)
        )(obs, img1, m0)
    err = float(np.abs(np.asarray(one.state.model.t) - np.asarray(model.t)).max())
    check(not bool(failed) and err < 1e-3, f"point-sharded LM solve: max |dt| {err:.2e} m < 1e-3")

    fn, (q, t, lq, lt) = pose_graph_solve(n_nodes=100)
    graph = pose_graph.odometry_graph(
        Pose(jnp.asarray(q), jnp.asarray(t)),
        loop_edges=[(0, 99, Pose(jnp.asarray(lq), jnp.asarray(lt)))],
    )
    one = jax.jit(pose_graph.solve_sparse)(graph)
    edge_mesh = mesh_mod.make_mesh((n_cards,), ("graph",), devices)
    many = jax.jit(lambda g: pose_graph.solve_sparse_sharded(g, edge_mesh))(graph)
    err = float(np.abs(np.asarray(one.nodes.t) - np.asarray(many.nodes.t)).max())
    check(err < 1e-3, f"edge-sharded PGO (100 nodes): max |dt| {err:.2e} m < 1e-3")


def run_cards(n_cards, workdir, h=H, w=W):
    import jax

    check(jax.local_device_count() >= n_cards, f"{jax.local_device_count()} local devices >= {n_cards}")
    seqs = render_lanes(h, w)
    assocs = [write(s, os.path.join(workdir, f"lane{b}")) for b, s in enumerate(seqs)]
    print(f"vors_batch, {len(seqs)} lanes on {n_cards} cards vs one card", flush=True)
    many = batch_lanes(
        assocs, seqs, os.path.join(workdir, "many"), ("--devices", str(n_cards)), timed=False
    )
    one = batch_lanes(assocs, seqs, os.path.join(workdir, "one"), ("--devices", "1"), timed=False)
    for b, ((e_many, p_many), (e_one, p_one)) in enumerate(zip(many, one)):
        diff = float(np.abs(p_many - p_one).max())
        check(
            e_many < ATE_BOUND and diff < POSE_AGREE,
            f"lane {b}: ATE {e_many:.6f} on {n_cards} cards, {e_one:.6f} on one; "
            f"max |dpose| {diff:.3e} m",
        )
    check_lane_placement(seqs, n_cards)
    print("sharded solves", flush=True)
    check_sharded_solves(seqs[0], n_cards)


# ---------------------------------------------------------------------------


def run_one_card(workdir, h=H, w=W):
    import jax

    t0 = time.perf_counter()
    seq = render_main_sequence(h, w)
    lanes = render_lanes(h, w)
    assoc = write(seq, os.path.join(workdir, "main"))
    lane_assocs = [write(s, os.path.join(workdir, f"lane{b}")) for b, s in enumerate(lanes)]
    print(
        f"rendered {len(seq.poses)} + {sum(len(s.poses) for s in lanes)} frames at "
        f"{w}x{h} in {time.perf_counter() - t0:.1f} s", flush=True,
    )
    traj_a = phase_track(assoc, seq)
    phase_batch(lane_assocs, lanes, os.path.join(workdir, "batch"))
    phase_refine(assoc, seq, traj_a, workdir)

    print("exactness on the card", flush=True)
    check_samplers(h, w)
    check_extraction(seq.depths[0], seq.grays[0])
    check_lane_moves()

    print("GPU against CPU", flush=True)
    cpu = jax.devices("cpu")[0]
    # LM accept/stop decisions are discrete: reassociated f32 sums can end a
    # solve one iteration apart, which moves a converged pose by well under 1 mm
    compare_backends("track_frame x5", lambda: track_five(seq), 1e-3, cpu)
    compare_backends("photometric window solve", lambda: window_solve(seq), 1e-3, cpu)
    compare_backends("pose-graph solve", pose_graph_solve, 1e-3, cpu)


def gpu_name_and_power() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--cards", type=int, default=1,
        help="1: every phase on one card; N > 1: only the sharded paths on N cards",
    )
    args = parser.parse_args(argv)

    # keep the host CPU backend next to the GPU for the GPU-against-CPU phase
    platforms = os.environ.get("JAX_PLATFORMS")
    if platforms and "cpu" not in platforms.split(","):
        os.environ["JAX_PLATFORMS"] = platforms + ",cpu"
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (JAX's default device is {dev.platform})", file=sys.stderr)
        return 1
    print(gpu_name_and_power(), flush=True)
    print(f"jax {jax.__version__}, {len(jax.devices())} x {dev.device_kind}", flush=True)

    from visual_odometry_rs_tpu.cli import _common

    print(f"compilation cache: {_common.enable_compilation_cache()}", flush=True)
    t0 = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
            if args.cards > 1:
                run_cards(args.cards, workdir)
                count = args.cards
            else:
                run_one_card(workdir)
                count = 1
    except CheckFailed as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    print(f"all phases passed in {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": dev.platform, "kind": dev.device_kind, "count": count},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
