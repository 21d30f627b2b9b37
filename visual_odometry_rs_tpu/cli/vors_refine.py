"""CLI: offline windowed photometric refinement of a tracked trajectory.

    python -m visual_odometry_rs_tpu.cli.vors_refine fr1 associations.txt \\
        trajectory.txt [--window 6] > refined.txt

Post-processes a TUM-format trajectory produced by ``vors_track`` (or any
TUM trajectory aligned with the associations file) with the sliding-window
optimization the reference defers to future work (its README.md:54-55).

Two modes:

- ``--mode sliding`` (default): DSO-style keyframe-anchored window
  (``models.sliding_window``) — advances one frame at a time, jointly
  refining the window's poses and the keyframe candidates' inverse depths
  with the Schur-reduced photometric LM solve, MARGINALIZING departed
  frames into a Gaussian pose prior and switching keyframes on the
  tracker's optical-flow criterion.
- ``--mode chunked``: disjoint ``--window``-frame chunks overlapping by one
  frame; one solve per chunk (cheaper, no marginalization).

Refined trajectory prints to stdout in TUM format; diagnostics to stderr.
"""

from __future__ import annotations

import argparse
import sys

from . import _common

USAGE = "Usage: vors_refine [fr1|fr2|fr3|icl] associations_file trajectory_file"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(usage=USAGE)
    parser.add_argument("camera_id", choices=["fr1", "fr2", "fr3", "icl"])
    parser.add_argument("associations_file")
    parser.add_argument("trajectory_file")
    parser.add_argument(
        "extra_pairs", nargs="*", metavar="ASSOC TRAJ",
        help="--batch mode: additional associations/trajectory file pairs "
        "(one pair per extra lane)",
    )
    parser.add_argument(
        "--batch", action="store_true",
        help="refine ALL given (associations, trajectory) pairs together in "
        "lockstep with ONE vmapped marginalized-window solve per step "
        "(models.sliding_window.BatchedSlidingWindow) — the data-parallel "
        "refinement mode; requires --out-dir, writes one refined TUM "
        "trajectory per lane.  When the lane count divides the local device "
        "count, the lane axis is sharded over a 'data' mesh (SPMD)",
    )
    parser.add_argument(
        "--out-dir", metavar="DIR",
        help="--batch mode: output directory for per-lane refined "
        "trajectories (named after each association file's parent directory)",
    )
    parser.add_argument(
        "--max-frames", type=int, default=0, metavar="N",
        help="--batch mode: stop after the first N global frames (0 = all) — "
        "slice long runs into restartable pieces with --save-state/--resume",
    )
    parser.add_argument("--cpu", action="store_true", help="force the CPU backend")
    parser.add_argument("--window", type=int, default=6)
    parser.add_argument(
        "--mode", choices=["sliding", "chunked"], default="sliding",
        help="'sliding' (default): DSO-style keyframe-anchored window that "
        "advances one frame at a time, marginalizing departed frames into "
        "a pose prior and switching keyframes on the tracker's optical-flow "
        "criterion (models.sliding_window).  'chunked': the round-1 "
        "behavior — disjoint --window-frame chunks overlapping by one "
        "frame (cheaper: one solve per chunk instead of per frame).",
    )
    parser.add_argument(
        "--no-marginalization", action="store_true",
        help="sliding mode: drop departed frames instead of marginalizing",
    )
    parser.add_argument(
        "--coarse-level", type=int, default=1,
        help="sliding mode: pyramid level of the pose-only pre-solve that "
        "widens the convergence basin (0 disables)",
    )
    parser.add_argument("--nb-levels", type=int, default=6,
                        help="pyramid depth for candidate selection")
    parser.add_argument("--candidate-cap", type=int, default=2048)
    _common.add_compilation_cache_arg(parser)
    parser.add_argument("--max-iterations", type=int, default=15)
    parser.add_argument(
        "--interp",
        choices=["auto", "gather", "onehot", "onehot_weighted"],
        default="auto",
        help="bilinear sampling implementation for the window solve "
        "(auto = gather)",
    )
    parser.add_argument(
        "--robust-delta", type=float, default=0.0,
        help="Huber robust weighting threshold in intensity units (0 = L2)",
    )
    parser.add_argument(
        "--brightness-model", action="store_true",
        help="estimate per-frame affine brightness (gain/bias) in each window",
    )
    parser.add_argument("--idepth-prior-weight", type=float, default=1e4)
    parser.add_argument(
        "--save-state", metavar="PATH",
        help="sliding mode: checkpoint the window state to PATH every "
        "--save-every frames (and at the end)",
    )
    parser.add_argument("--save-every", type=int, default=50, metavar="N")
    parser.add_argument(
        "--resume", metavar="PATH",
        help="sliding mode: resume from a --save-state checkpoint (refuses "
        "on config/window mismatch); already-processed frames are skipped",
    )
    parser.add_argument(
        "--export-cloud", metavar="PATH",
        help="sliding mode: write the refined sparse 3D map (each retiring "
        "keyframe's candidates with their window-REFINED inverse depths, "
        "back-projected through the refined poses) as an ASCII PLY file",
    )
    parser.add_argument(
        "--cloud-voxel", type=float, default=0.0, metavar="METERS",
        help="voxel-grid downsample the exported cloud (one centroid point "
        "per cube); 0 = keep every point",
    )
    parser.add_argument(
        "--energy-tol", type=float, default=1.0,
        help="per-pair d_energy stop (intensity^2).  The default matches the "
        "reference tracker's coarse stop: refinement corrects gross error "
        "but does not descend into the ~0.2 px photometric bias floor of "
        "quantized images (which would degrade already-good trajectories). "
        "Lower it for noisy sensors where the photometric signal dominates.",
    )
    args = parser.parse_args(argv)

    if args.mode != "sliding" and (args.save_state or args.resume):
        # a chunked run accepting --save-state would exit 0 having written
        # no checkpoint — the loss would only surface at resume time
        parser.error("--save-state/--resume require --mode sliding")
    if args.mode != "sliding" and args.export_cloud:
        parser.error("--export-cloud requires --mode sliding")
    if args.extra_pairs and not args.batch:
        parser.error("extra associations/trajectory pairs require --batch")
    if args.batch:
        if len(args.extra_pairs) % 2 != 0:
            parser.error(
                "--batch needs an even number of extra positionals "
                "(ASSOC TRAJ pairs)"
            )
        if not args.out_dir:
            parser.error("--batch requires --out-dir")
        if args.mode != "sliding":
            parser.error("--batch supports --mode sliding only")
        if args.export_cloud:
            parser.error(
                "--export-cloud is not available in --batch mode (use "
                "per-sequence vors_refine runs for map export)"
            )

    _common.apply_compilation_cache(args)
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    if args.batch:
        pairs = [(args.associations_file, args.trajectory_file)] + [
            (args.extra_pairs[i], args.extra_pairs[i + 1])
            for i in range(0, len(args.extra_pairs), 2)
        ]
        return _run_batched(args, pairs)

    import jax
    import jax.numpy as jnp
    import numpy as np

    from ..dataset import tum_rgbd
    from ..math import pose as pose_mod
    from ..math.pose import Pose
    from ..models import photometric_ba, tracker as tracker_mod
    from ..ops import pyramid as pyramid_ops

    try:
        associations = tum_rgbd.load_associations(args.associations_file)
        with open(args.trajectory_file) as f:
            trajectory = tum_rgbd.parse_trajectory(f.read())
    except OSError as e:
        print(USAGE, file=sys.stderr)
        print(f"Cannot read inputs: {e}", file=sys.stderr)
        return 1

    # vors_track emits one line per association after the first; frame 0 is
    # the (identity) initialization.  Build camera-to-world per association.
    if len(trajectory) != len(associations) - 1:
        print(
            f"trajectory has {len(trajectory)} lines; expected "
            f"{len(associations) - 1} (one per association after the first)",
            file=sys.stderr,
        )
        return 1
    c2w = [pose_mod.identity()] + [f.pose for f in trajectory]

    depth0, gray0 = tum_rgbd.read_images(associations[0])
    h, w = gray0.shape
    config = tracker_mod.TrackerConfig(
        height=h,
        width=w,
        nb_levels=args.nb_levels,
        candidate_cap=args.candidate_cap,
        depth_scale=tum_rgbd.DEPTH_SCALE,
    )

    intrinsics = tum_rgbd.scaled_intrinsics(args.camera_id, h, w)
    if (h, w) != (tum_rgbd.NATIVE_HEIGHT, tum_rgbd.NATIVE_WIDTH):
        print(f"note: {args.camera_id} intrinsics rescaled to {w}x{h} inputs", file=sys.stderr)

    if args.mode == "sliding":
        from ..models import sliding_window

        sw = sliding_window.SlidingWindow(
            config, intrinsics,
            window_size=max(2, args.window),
            marginalize=not args.no_marginalization,
            coarse_level=args.coarse_level,
            max_iterations=args.max_iterations,
            idepth_prior_weight=args.idepth_prior_weight,
            energy_tol=args.energy_tol,
            interp_method=args.interp,
            robust_delta=args.robust_delta,
            brightness=args.brightness_model,
            collect_clouds=bool(args.export_cloud),
        )
        from ..utils import checkpoint as ckpt_mod

        refined = [None] * len(associations)

        def _refined_extra():
            # refined-so-far trajectory rides in the checkpoint so a resume
            # does not discard the refinement of frames that already left
            # the window
            q = np.stack([
                np.asarray(p.q) if p is not None else np.zeros(4, np.float32)
                for p in refined
            ])
            t = np.stack([
                np.asarray(p.t) if p is not None else np.zeros(3, np.float32)
                for p in refined
            ])
            mask = np.array([p is not None for p in refined])
            # consumed-frame timestamps bind the checkpoint to THIS input
            # sequence: config/window fingerprints alone would silently
            # accept a resume against a different dataset with the same
            # camera, mixing incompatible state
            ts = np.array(
                [a.depth_timestamp for a in associations[: sw._next_id]],
                np.float64,
            )
            extra = {"refined_q": q, "refined_t": t, "refined_mask": mask,
                     "consumed_ts": ts}
            if args.export_cloud:
                # retired refined clouds ride along so a resumed export
                # still contains pre-checkpoint keyframes
                pts = [p for p, _ in sw.retired_clouds]
                ints = [i for _, i in sw.retired_clouds]
                extra["cloud_pts"] = (
                    np.concatenate(pts) if pts else np.zeros((0, 3), np.float32)
                )
                extra["cloud_int"] = (
                    np.concatenate(ints) if ints else np.zeros((0,), np.uint8)
                )
            return extra

        start_at = 1
        if args.resume:
            try:
                extra = ckpt_mod.load_sliding_window(args.resume, sw)
            except (ckpt_mod.CheckpointMismatchError, OSError, KeyError,
                    ValueError) as e:
                # ValueError: np.load on a corrupt / non-npz file
                print(f"Cannot resume: {e}", file=sys.stderr)
                return 1
            start_at = sw._next_id
            saved_ts = extra.get("consumed_ts")
            if saved_ts is not None and not ckpt_mod.sequence_matches(
                saved_ts, associations
            ):
                print(
                    "Cannot resume: checkpoint was written for a "
                    "different input sequence (consumed-frame timestamps "
                    "do not match the associations file)",
                    file=sys.stderr,
                )
                return 1
            print(
                f"resumed from {args.resume}: {start_at} frames already "
                f"processed, {sw.keyframe_switches} keyframe switches",
                file=sys.stderr,
            )
            if "refined_mask" in extra:
                for fid in range(len(associations)):
                    if fid < len(extra["refined_mask"]) and extra["refined_mask"][fid]:
                        refined[fid] = Pose(
                            jnp.asarray(extra["refined_q"][fid]),
                            jnp.asarray(extra["refined_t"][fid]),
                        )
            if args.export_cloud:
                if "cloud_pts" in extra:
                    sw.retired_clouds.append(
                        (
                            np.asarray(extra["cloud_pts"], np.float32),
                            np.asarray(extra["cloud_int"], np.uint8),
                        )
                    )
                elif sw.keyframe_switches > 0:
                    print(
                        "warning: checkpoint was saved without "
                        "--export-cloud; the exported map will only cover "
                        "keyframes from this resumed run",
                        file=sys.stderr,
                    )
            # skip consumed frames WITHOUT decoding them
            loader = iter(tum_rgbd.frame_loader(associations[start_at:]))
        else:
            loader = iter(tum_rgbd.frame_loader(associations))
            depth0_s, gray0_s = next(loader)
            sw.start(depth0_s, gray0_s, c2w[0])
            refined[0] = c2w[0]
        for i, (depth_i, gray_i) in enumerate(loader, start=start_at):
            ids, poses = sw.add_frame(depth_i, gray_i, c2w[i])
            for fid, p in zip(ids, poses):
                refined[fid] = p  # latest estimate wins (windows overlap)
            print(
                f"frame {i}: window {ids[0]}..{ids[-1]}, "
                f"keyframe switches {sw.keyframe_switches}",
                file=sys.stderr,
            )
            if args.save_state and (
                (i - start_at + 1) % max(1, args.save_every) == 0
                or i == len(associations) - 1
            ):
                ckpt_mod.save_sliding_window(args.save_state, sw, _refined_extra())
                print(f"checkpointed window state to {args.save_state}",
                      file=sys.stderr)
        for i, assoc in enumerate(associations[1:], start=1):
            pose = refined[i] if refined[i] is not None else c2w[i]
            print(tum_rgbd.Frame(timestamp=assoc.depth_timestamp, pose=pose).to_string())
        if args.export_cloud:
            from ..utils import pointcloud

            clouds = list(sw.retired_clouds) + [sw.keyframe_cloud()]
            pts = np.concatenate([p for p, _ in clouds])
            inten = np.concatenate([i for _, i in clouds])
            pts, inten = pointcloud.voxel_downsample(pts, inten, args.cloud_voxel)
            pointcloud.write_ply(args.export_cloud, pts, inten)
            print(
                f"exported {len(pts)} refined map points to {args.export_cloud}",
                file=sys.stderr,
            )
        return 0

    precompute = jax.jit(
        lambda d, p: tracker_mod.precompute_keyframe(config, intrinsics, d, p)
    )
    solve = jax.jit(
        lambda win: photometric_ba.solve_window(
            win,
            max_iterations=args.max_iterations,
            idepth_prior_weight=args.idepth_prior_weight,
            energy_tol=args.energy_tol,
            interp_method=args.interp,
            robust_delta=args.robust_delta,
            brightness=args.brightness_model,
        )
    )

    # stream frames with a rolling window buffer: only the live window's
    # frames are resident (a full TUM sequence would be GBs if materialized)
    loader = iter(tum_rgbd.frame_loader(associations))
    W = max(2, args.window)
    refined: list = [None] * len(associations)
    refined[0] = c2w[0]

    def refill(buf):
        while len(buf) < W:
            nxt = next(loader, None)
            if nxt is None:
                break
            buf.append(nxt)
        return buf

    buf = refill([])
    k0 = 0
    while len(buf) >= 2:
        k_end = k0 + len(buf)
        idxs = list(range(k0, k_end))
        depth_kf, gray_kf = buf[0]
        pyr = pyramid_ops.mean_pyramid(config.nb_levels, jnp.asarray(gray_kf))
        kf = precompute(jnp.asarray(depth_kf), pyr)
        images = jnp.asarray(
            np.stack([g for _, g in buf]).astype(np.float32)
        )
        kf_pose = refined[k0] if refined[k0] is not None else c2w[k0]
        rel = [
            pose_mod.compose(pose_mod.inverse(c2w[i]), c2w[k0]) for i in idxs
        ]
        init_poses = Pose(
            jnp.stack([p.q for p in rel]), jnp.stack([p.t for p in rel])
        )
        win = photometric_ba.window_from_tracking(
            config, intrinsics, kf.levels, images, init_poses
        )
        result = solve(win)
        print(
            f"window {k0}..{k_end - 1}: {int(result.nb_iter)} iterations, "
            f"energy {float(result.energy):.1f}",
            file=sys.stderr,
        )
        for j, i in enumerate(idxs):
            # cam_i = kf_pose * inverse(model_i), anchored at the refined kf
            refined[i] = pose_mod.compose(
                kf_pose,
                pose_mod.inverse(Pose(result.poses.q[j], result.poses.t[j])),
            )

        # slide: the last frame of this window keyframes the next one
        k0 = k_end - 1
        buf = refill([buf[-1]])
        if len(buf) < 2:
            break

    for i, assoc in enumerate(associations[1:], start=1):
        pose = refined[i] if refined[i] is not None else c2w[i]
        print(
            tum_rgbd.Frame(timestamp=assoc.depth_timestamp, pose=pose).to_string()
        )
    return 0


def _run_batched(args, pairs) -> int:
    """Lockstep data-parallel refinement of B (associations, trajectory)
    pairs: one ``BatchedSlidingWindow.add_frame`` per global frame index —
    each step is ONE vmapped coarse+full marginalized-window solve across
    all lanes (plus one vmapped marginalization / keyframe precompute when
    due), instead of B per-sequence host loops.

    Lanes may have different lengths: finished lanes keep receiving their
    final frame (flow ~0, prior intact) and stop emitting output lines —
    the same convention as ``vors_batch``.
    """
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ..dataset import tum_rgbd
    from ..math import pose as pose_mod
    from ..math.pose import Pose
    from ..models import sliding_window, tracker as tracker_mod
    from ..parallel import mesh as mesh_mod
    from ..utils import checkpoint as ckpt_mod
    from .vors_batch import _out_name

    B = len(pairs)
    all_assocs, all_c2w = [], []
    for ap, tp in pairs:
        try:
            assocs = tum_rgbd.load_associations(ap)
            with open(tp) as f:
                traj = tum_rgbd.parse_trajectory(f.read())
        except OSError as e:
            print(f"Cannot read inputs: {e}", file=sys.stderr)
            return 1
        if not assocs:
            print(f"Empty associations file: {ap}", file=sys.stderr)
            return 1
        if len(traj) != len(assocs) - 1:
            print(
                f"{tp}: trajectory has {len(traj)} lines; expected "
                f"{len(assocs) - 1} (one per association after the first)",
                file=sys.stderr,
            )
            return 1
        all_assocs.append(assocs)
        all_c2w.append([pose_mod.identity()] + [f.pose for f in traj])

    first = [tum_rgbd.read_images(a[0]) for a in all_assocs]
    shapes = {g.shape for _, g in first}
    if len(shapes) != 1:
        print(f"All lanes must share one image shape, got {shapes}", file=sys.stderr)
        return 1
    h, w = next(iter(shapes))
    intrinsics = tum_rgbd.scaled_intrinsics(args.camera_id, h, w)
    if (h, w) != (tum_rgbd.NATIVE_HEIGHT, tum_rgbd.NATIVE_WIDTH):
        print(f"note: {args.camera_id} intrinsics rescaled to {w}x{h} inputs", file=sys.stderr)
    config = tracker_mod.TrackerConfig(
        height=h, width=w, nb_levels=args.nb_levels,
        candidate_cap=args.candidate_cap, depth_scale=tum_rgbd.DEPTH_SCALE,
    )

    mesh = None
    n_dev = jax.local_device_count()
    if B % n_dev == 0 and n_dev > 1:
        mesh = mesh_mod.make_mesh((n_dev,), ("data",))
        print(f"sharding {B} lanes over {n_dev} devices", file=sys.stderr)

    bsw = sliding_window.BatchedSlidingWindow(
        config, intrinsics,
        window_size=max(2, args.window),
        marginalize=not args.no_marginalization,
        coarse_level=args.coarse_level,
        max_iterations=args.max_iterations,
        idepth_prior_weight=args.idepth_prior_weight,
        energy_tol=args.energy_tol,
        interp_method=args.interp,
        robust_delta=args.robust_delta,
        brightness=args.brightness_model,
        mesh=mesh,
    )

    lengths = [len(a) - 1 for a in all_assocs]
    max_len = max(lengths)
    stop_at = min(max_len, args.max_frames) if args.max_frames > 0 else max_len
    T = max_len + 1
    refined = [[None] * (lengths[b] + 1) for b in range(B)]
    loaders = [iter(tum_rgbd.frame_loader(a)) for a in all_assocs]
    last = [None] * B

    def _extra():
        q = np.zeros((B, T, 4), np.float32)
        t = np.zeros((B, T, 3), np.float32)
        mask = np.zeros((B, T), bool)
        ts = np.full((B, T), np.nan, np.float64)
        for b in range(B):
            for fid, p in enumerate(refined[b]):
                if p is not None:
                    q[b, fid] = np.asarray(p.q)
                    t[b, fid] = np.asarray(p.t)
                    mask[b, fid] = True
            k = min(bsw._next_id, lengths[b] + 1)
            ts[b, :k] = [a.depth_timestamp for a in all_assocs[b][:k]]
        return {"refined_q": q, "refined_t": t, "refined_mask": mask,
                "consumed_ts": ts}

    start_at = 1
    if args.resume:
        try:
            extra = ckpt_mod.load_batched_window(args.resume, bsw)
        except (ckpt_mod.CheckpointMismatchError, OSError, KeyError,
                ValueError) as e:
            print(f"Cannot resume: {e}", file=sys.stderr)
            return 1
        start_at = bsw._next_id
        saved_ts = extra.get("consumed_ts")
        if saved_ts is not None:
            if saved_ts.shape[0] != B:
                print(
                    f"Cannot resume: checkpoint has {saved_ts.shape[0]} "
                    f"lanes, {B} pairs given", file=sys.stderr,
                )
                return 1
            for b in range(B):
                prefix = saved_ts[b][~np.isnan(saved_ts[b])]
                if not ckpt_mod.sequence_matches(prefix, all_assocs[b]):
                    print(
                        f"Cannot resume: lane {b} ({pairs[b][0]}) does not "
                        "match the checkpoint's consumed frames — resume "
                        "with the SAME pairs in the SAME order",
                        file=sys.stderr,
                    )
                    return 1
        if "refined_mask" in extra:
            for b in range(B):
                for fid in range(min(T, extra["refined_mask"].shape[1])):
                    if fid <= lengths[b] and extra["refined_mask"][b, fid]:
                        refined[b][fid] = Pose(
                            extra["refined_q"][b, fid],
                            extra["refined_t"][b, fid],
                        )
        for b in range(B):
            for _ in range(min(start_at, lengths[b] + 1)):
                last[b] = next(loaders[b])
        print(
            f"resumed {B} lanes at global frame {start_at}", file=sys.stderr
        )
    else:
        for b in range(B):
            last[b] = next(loaders[b])  # frame 0
        c2w0 = Pose(
            jnp.stack([all_c2w[b][0].q for b in range(B)]),
            jnp.stack([all_c2w[b][0].t for b in range(B)]),
        )
        bsw.start(
            np.stack([d for d, _ in last]), np.stack([g for _, g in last]),
            c2w0,
        )
        for b in range(B):
            refined[b][0] = all_c2w[b][0]

    for i in range(start_at, stop_at + 1):
        for b in range(B):
            if i <= lengths[b]:
                last[b] = next(loaders[b])
        depths = np.stack([d for d, _ in last])
        grays = np.stack([g for _, g in last])
        inits = [all_c2w[b][min(i, lengths[b])] for b in range(B)]
        c2w_i = Pose(
            jnp.stack([p.q for p in inits]), jnp.stack([p.t for p in inits])
        )
        ids, poses_ref = bsw.add_frame(depths, grays, c2w_i)
        qs = np.asarray(poses_ref.q)
        ts = np.asarray(poses_ref.t)
        for b in range(B):
            for slot in range(ids.shape[0]):
                fid = int(ids[slot, b])
                if fid <= lengths[b]:
                    # host numpy Poses: these are only ever serialized /
                    # snapshotted host-side, and B x window jnp.asarray
                    # calls per frame would each be a device transfer
                    refined[b][fid] = Pose(qs[b, slot], ts[b, slot])
        print(
            f"frame {i}: window {int(ids[:, 0].min())}..{int(ids[:, 0].max())}"
            f", keyframe switches {list(map(int, bsw.keyframe_switches))}",
            file=sys.stderr,
        )
        if args.save_state and (
            (i - start_at + 1) % max(1, args.save_every) == 0 or i == stop_at
        ):
            ckpt_mod.save_batched_window(args.save_state, bsw, _extra())
            print(f"checkpointed batched window state to {args.save_state}",
                  file=sys.stderr)

    import os

    os.makedirs(args.out_dir, exist_ok=True)
    names, seen = [], {}
    for ap, _ in pairs:
        name = _out_name(ap)
        if name in seen:
            seen[name] += 1
            stem, ext = os.path.splitext(name)
            name = f"{stem}.{seen[name]}{ext}"
        else:
            seen[name] = 0
        names.append(name)
    for b, name in enumerate(names):
        with open(os.path.join(args.out_dir, name), "w") as fh:
            for fid, assoc in enumerate(all_assocs[b][1:], start=1):
                pose = refined[b][fid] if refined[b][fid] is not None else all_c2w[b][fid]
                fh.write(
                    tum_rgbd.Frame(
                        timestamp=assoc.depth_timestamp, pose=pose
                    ).to_string() + "\n"
                )
    print(f"wrote {B} refined trajectories to {args.out_dir}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
