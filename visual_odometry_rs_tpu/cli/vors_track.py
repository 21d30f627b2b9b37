"""CLI: track a TUM RGB-D sequence and print the trajectory to stdout.

The product entry point, mirroring reference ``src/bin/vors_track.rs``:

    python -m visual_odometry_rs_tpu.cli.vors_track [fr1|fr2|fr3|icl] associations_file

Prints one TUM-format pose line per tracked frame to stdout
(``timestamp tx ty tz qx qy qz qw``); diagnostics (optical flow, keyframe
switches, failures) go to stderr — the reference's clean stdout/stderr
separation (vors_track.rs:63 vs inverse_compositional.rs:222).

Config matches the reference's hardcoded values (vors_track.rs:34-40):
nb_levels=6, candidates_diff_threshold=7, depth_scale=5000,
idepth_variance=1e-4.
"""

from __future__ import annotations

import argparse
import sys

from . import _common

USAGE = "Usage: vors_track [fr1|fr2|fr3|icl] associations_file"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(usage=USAGE)
    parser.add_argument("camera_id", choices=["fr1", "fr2", "fr3", "icl"])
    parser.add_argument("associations_file")
    parser.add_argument("--cpu", action="store_true", help="force the CPU backend")
    parser.add_argument("--nb-levels", type=int, default=6)
    parser.add_argument("--diff-threshold", type=int, default=7)
    parser.add_argument("--candidate-cap", type=int, default=8192)
    parser.add_argument(
        "--interp",
        choices=["auto", "gather", "onehot", "onehot_weighted"],
        default="auto",
        help="bilinear sampling implementation",
    )
    parser.add_argument(
        "--robust-delta", type=float, default=0.0,
        help="Huber robust weighting threshold in intensity units "
        "(0 = reference-exact L2)",
    )
    parser.add_argument(
        "--candidate-selector", choices=["coarse_to_fine", "dso", "dso_fixed"],
        default="coarse_to_fine",
        help="keyframe candidate picker: coarse_to_fine (the reference "
        "tracker's selector), dso (the faithful DSO point picker, "
        "dso.rs:98-147; host-side recursion, so not available with --chunk) "
        "or dso_fixed (recursion-free DSO at a static --dso-block-size — "
        "jittable, available with --chunk and in vors_batch)",
    )
    parser.add_argument(
        "--dso-target", type=int, default=2000,
        help="DSO selector point-count target (dso: block size adapts "
        "toward it; dso_fixed: sets the random-thinning ratio)",
    )
    parser.add_argument(
        "--dso-block-size", type=int, default=4,
        help="dso_fixed: the static block size (the dso recursion's "
        "adaptation target; 4 is the DSO-paper base)",
    )
    parser.add_argument(
        "--dso-a", type=float, default=1.0,
        help="DSO regional threshold coefficient a in a*(mean3x3(median)+b)^2 "
        "(dso.rs:74: '(2.0,3) in dso and (1.0,3) in ldso'); lower it on "
        "weakly-textured scenes (tools/accuracy_matrix.py)",
    )
    parser.add_argument(
        "--brightness-model", action="store_true",
        help="estimate per-frame affine brightness (gain/bias) jointly with "
        "the pose — for auto-exposure cameras",
    )
    parser.add_argument(
        "--relocalize", type=int, default=0, metavar="K",
        help="streaming mode: keep the last K keyframes and recover a lost "
        "track (solver failure or photometric energy above "
        "--relocalize-energy) against them in one vmapped solve; 0 = off "
        "(reference-exact behavior: a lost frame keeps its previous pose)",
    )
    parser.add_argument(
        "--relocalize-energy", type=float, default=150.0,
        help="mean squared intensity above which a frame counts as lost",
    )
    parser.add_argument(
        "--warm-start", choices=["constant_position", "constant_velocity"],
        default="constant_position",
        help="per-frame LM init: constant_position is reference-exact "
        "(inverse_compositional.rs:177); constant_velocity extrapolates the "
        "previous inter-frame motion, cutting LM iterations on smooth video",
    )
    parser.add_argument(
        "--level-iterations", metavar="N0,N1,...", default=None,
        help="comma-separated per-level LM iteration caps (finest first, "
        "one per pyramid level); default: the reference's 20 at every level",
    )
    parser.add_argument(
        "--metrics", action="store_true",
        help="print per-frame JSON metrics and a session summary to stderr",
    )
    parser.add_argument(
        "--no-bucket", action="store_true",
        help="disable host-side candidate-cap bucketing (exact worst-case shapes)",
    )
    parser.add_argument(
        "--chunk", type=int, default=0, metavar="N",
        help="fused serving mode: track N frames per device dispatch with the "
        "lax.scan clip driver (keyframe switching in-graph); trajectory lines "
        "print once per chunk instead of per frame — one host round trip "
        "per chunk",
    )
    _common.add_compilation_cache_arg(parser)
    parser.add_argument("--save-state", help="checkpoint tracker state here at the end")
    parser.add_argument("--resume", help="restore tracker state from a checkpoint")
    args = parser.parse_args(argv)
    _common.apply_compilation_cache(args)
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp

    from ..dataset import tum_rgbd
    from ..models import tracker as tracker_mod
    from ..utils import checkpoint as checkpoint_mod
    from ..utils import metrics as metrics_mod

    try:
        associations = tum_rgbd.load_associations(args.associations_file)
    except OSError as e:
        print(USAGE, file=sys.stderr)
        print(f"The association file does not exist or is not reachable: {e}", file=sys.stderr)
        return 1
    if not associations:
        print("Empty associations file", file=sys.stderr)
        return 1

    depth0, gray0 = tum_rgbd.read_images(associations[0])
    h, w = gray0.shape
    intrinsics = tum_rgbd.scaled_intrinsics(args.camera_id, h, w)
    if (h, w) != (tum_rgbd.NATIVE_HEIGHT, tum_rgbd.NATIVE_WIDTH):
        print(
            f"note: {args.camera_id} intrinsics rescaled to {w}x{h} inputs",
            file=sys.stderr,
        )
    config = tracker_mod.TrackerConfig(
        height=h,
        width=w,
        nb_levels=args.nb_levels,
        candidates_diff_threshold=args.diff_threshold,
        depth_scale=tum_rgbd.DEPTH_SCALE,
        idepth_variance=1e-4,
        candidate_cap=args.candidate_cap,
        interp_method=args.interp,
        bucket_candidates=not args.no_bucket,
        robust_delta=args.robust_delta,
        brightness_model=args.brightness_model,
        relocalize_window=max(0, args.relocalize),
        relocalize_energy_accept=args.relocalize_energy,
        candidate_selector=args.candidate_selector,
        dso_target=args.dso_target,
        dso_block_size=args.dso_block_size,
        dso_threshold_coef_a=args.dso_a,
        warm_start=args.warm_start,
        level_max_iterations=_common.parse_level_iterations(
            args.level_iterations, args.nb_levels
        ),
    )
    if args.chunk > 0:
        if args.candidate_selector == "dso":
            print(
                "--candidate-selector dso needs the host-side block-size "
                "recursion and is not supported with --chunk (in-graph "
                "keyframe precompute); run without --chunk",
                file=sys.stderr,
            )
            return 1
        if args.resume or args.save_state:
            print(
                "--chunk uses functional (device-resident) tracker state and "
                "does not support --resume/--save-state; run without --chunk "
                "for checkpointing",
                file=sys.stderr,
            )
            return 1
        if args.relocalize > 0:
            print(
                "--relocalize is a streaming-Tracker recovery path and is "
                "not supported with --chunk (the fused scan has no host "
                "keyframe ring); run without --chunk",
                file=sys.stderr,
            )
            return 1
        return _run_chunked(args, config, intrinsics, associations, depth0, gray0)

    trk = tracker_mod.init_tracker(
        config,
        intrinsics,
        associations[0].depth_timestamp,
        jnp.asarray(depth0),
        associations[0].color_timestamp,
        jnp.asarray(gray0),
    )

    if args.resume:
        try:
            checkpoint_mod.load_tracker(args.resume, trk)
        except checkpoint_mod.CheckpointMismatchError as e:
            print(f"Cannot resume: {e}", file=sys.stderr)
            return 1
        except (OSError, KeyError, ValueError) as e:
            print(f"Cannot read checkpoint {args.resume}: {e}", file=sys.stderr)
            return 1
        # resume semantics here are "continue into the SUPPLIED file": every
        # association after the first is tracked.  Warn when the file starts
        # at or before the checkpoint's last tracked frame — the caller
        # probably passed the original full file and would double-track it
        # (vors_refine/vors_slam skip consumed frames instead; this CLI
        # keeps the reference's stateless stream model).
        if (
            len(associations) > 1
            and associations[1].depth_timestamp
            <= trk.current_depth_timestamp + 1e-9
        ):
            print(
                "warning: the first frame to track "
                f"({associations[1].depth_timestamp:.6f}) is not after the "
                "checkpoint's last tracked frame "
                f"({trk.current_depth_timestamp:.6f}) — frames will be "
                "double-tracked; pass only the REMAINING associations when "
                "resuming",
                file=sys.stderr,
            )

    session = metrics_mod.SessionMetrics()
    # Native prefetch loader: PNG decode of upcoming frames overlaps the
    # device-side tracking of the current one (dataset.frame_loader).
    frames = tum_rgbd.frame_loader(associations[1:])
    for idx, (assoc, (depth, gray)) in enumerate(
        zip(associations[1:], frames), start=1
    ):
        switches_before = trk.keyframe_switches
        relocs_before = trk.relocalizations
        with metrics_mod.Timer() as timer:
            trk.track(
                assoc.depth_timestamp,
                jnp.asarray(depth),
                assoc.color_timestamp,
                jnp.asarray(gray),
            )
        print(f"Optical_flow: {trk.last_flow}", file=sys.stderr)
        if trk.last_failed:
            print("Error at Cholesky decomposition of hessian", file=sys.stderr)
        if trk.relocalizations > relocs_before:
            print(
                f"Relocalized against keyframe ring "
                f"(energy {trk.last_energy:.1f})",
                file=sys.stderr,
            )
        timestamp, pose = trk.current_frame()
        print(tum_rgbd.Frame(timestamp=timestamp, pose=pose).to_string(), flush=True)
        if args.metrics:
            m = metrics_mod.FrameMetrics(
                frame_index=idx,
                timestamp=timestamp,
                optical_flow=trk.last_flow,
                keyframe_switched=trk.keyframe_switches > switches_before,
                failed=trk.last_failed,
                track_seconds=timer.seconds,
            )
            session.record(m)
            print(m.to_json(), file=sys.stderr)

    if args.metrics:
        session.print_summary()
    if args.save_state:
        checkpoint_mod.save_tracker(args.save_state, trk)
    return 0


def _run_chunked(args, config, intrinsics, associations, depth0, gray0) -> int:
    """Fused serving loop: ``lax.scan`` clips of ``args.chunk`` frames.

    Tracker state (keyframe data + poses) stays device-resident between
    dispatches; keyframe switching runs in-graph behind a scan-level
    ``lax.cond`` (parallel.batch.track_sequence).  The host only stacks
    decoded frames and fetches the per-clip pose/diagnostic arrays — one
    round trip per chunk, which is what makes this the fast mode over
    remote/high-latency device transports.
    """
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ..dataset import tum_rgbd
    from ..math.pose import Pose
    from ..parallel import batch as batch_mod
    from ..utils import metrics as metrics_mod

    session = metrics_mod.SessionMetrics()
    frame_counter = [0]

    state = jax.jit(
        lambda d, g: batch_mod.init_state(config, intrinsics, d, g)
    )(jnp.asarray(depth0), jnp.asarray(gray0))
    # constant-velocity carry across chunk boundaries (zero velocity at start)
    prev_box = [state.current_pose]

    @jax.jit
    def run_clip(s, dd, gg, prev):
        return batch_mod.track_sequence(
            config, intrinsics, s, dd, gg, prev_pose0=prev, return_prev=True
        )

    buf_d, buf_g, buf_assoc = [], [], []

    def flush(state):
        if not buf_d:
            return state
        dd = jnp.asarray(np.stack(buf_d))
        gg = jnp.asarray(np.stack(buf_g))
        with metrics_mod.Timer() as timer:
            state, (poses, diags), prev_box[0] = run_clip(
                state, dd, gg, prev_box[0]
            )
            q = np.asarray(poses.q)
        t = np.asarray(poses.t)
        flows = np.asarray(diags.flow)
        fails = np.asarray(diags.failed)
        switched = np.asarray(diags.switched)
        per_frame_s = timer.seconds / len(buf_assoc)
        for i, a in enumerate(buf_assoc):
            print(f"Optical_flow: {flows[i]}", file=sys.stderr)
            if fails[i]:
                print("Error at Cholesky decomposition of hessian", file=sys.stderr)
            line = tum_rgbd.Frame(
                timestamp=a.depth_timestamp, pose=Pose(q=q[i], t=t[i])
            ).to_string()
            print(line)
            if args.metrics:
                frame_counter[0] += 1
                m = metrics_mod.FrameMetrics(
                    frame_index=frame_counter[0],
                    timestamp=a.depth_timestamp,
                    optical_flow=float(flows[i]),
                    keyframe_switched=bool(switched[i]),
                    failed=bool(fails[i]),
                    track_seconds=per_frame_s,
                )
                session.record(m)
                print(m.to_json(), file=sys.stderr)
        sys.stdout.flush()
        buf_d.clear()
        buf_g.clear()
        buf_assoc.clear()
        return state

    for assoc, (depth, gray) in zip(
        associations[1:], tum_rgbd.frame_loader(associations[1:])
    ):
        buf_d.append(depth)
        buf_g.append(gray)
        buf_assoc.append(assoc)
        if len(buf_d) == args.chunk:
            state = flush(state)
    flush(state)
    if args.metrics:
        session.print_summary()
    return 0


if __name__ == "__main__":
    sys.exit(main())
