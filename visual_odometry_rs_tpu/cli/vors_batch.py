"""CLI: track MANY TUM RGB-D sequences at once on one chip / a device mesh.

The green-field product surface of the scaling layer (SURVEY §2.3 — the
reference is strictly one-sequence-per-process, vors_track.rs:49):

    python -m visual_odometry_rs_tpu.cli.vors_batch fr1 \\
        seqA/associations.txt seqB/associations.txt --out-dir trajs/

All sequences are tracked together: frames are batched on the leading axis,
the per-frame step is ``vmap``-ed, clips of ``--chunk`` frames are fused into
one device dispatch with ``lax.scan`` (keyframe switching in-graph), and when
the batch divides the local device count the batch axis is sharded over a
``data`` mesh so the same program runs SPMD across chips.  Decode runs on the
native prefetch loaders, one per sequence, overlapping device compute.

Each input gets its own TUM-format trajectory file in ``--out-dir`` (named
after the association file's parent directory, falling back to its stem).
Sequences may have different lengths: finished sequences keep receiving
their final frame (flow ~0, state unchanged) and simply stop emitting lines.
"""

from __future__ import annotations

import argparse
import os
import sys

from . import _common

USAGE = "Usage: vors_batch [fr1|fr2|fr3|icl] associations_file... --out-dir DIR"


def _out_name(assoc_path: str) -> str:
    parent = os.path.basename(os.path.dirname(os.path.abspath(assoc_path)))
    if parent and parent not in (".", os.sep):
        return parent + ".txt"
    stem = os.path.splitext(os.path.basename(assoc_path))[0]
    return stem + ".txt"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(usage=USAGE)
    parser.add_argument("camera_id", choices=["fr1", "fr2", "fr3", "icl"])
    parser.add_argument("associations_files", nargs="+")
    parser.add_argument("--out-dir", required=True)
    parser.add_argument("--cpu", action="store_true", help="force the CPU backend")
    parser.add_argument("--nb-levels", type=int, default=6)
    parser.add_argument("--diff-threshold", type=int, default=7)
    parser.add_argument("--candidate-cap", type=int, default=8192)
    _common.add_compilation_cache_arg(parser)
    parser.add_argument(
        "--switch-cadence", type=int, default=1, metavar="K",
        help="batch keyframe switches onto every K-th frame (pending lanes "
        "switch together).  K=1 is reference-exact per-frame switching; "
        "K>1 trades slightly deferred switches for throughput when lanes "
        "switch on different frames (diverse sequences) — see "
        "parallel/batch.py",
    )
    parser.add_argument(
        "--switch-subbatch", type=int, default=0, metavar="K",
        help="on switch frames, precompute only the pending lanes compacted "
        "into a fixed K-lane sub-batch (falls back to all-lanes when more "
        "than K pend at once).  Same results as 0 (off), cheaper on diverse "
        "batches; -1 = auto (B/4) — see parallel/batch.py",
    )
    parser.add_argument("--chunk", type=int, default=8, metavar="N",
                        help="frames per fused device dispatch")
    parser.add_argument(
        "--devices", type=int, default=0, metavar="N",
        help="shard the lanes over the first N local devices when N > 1 "
        "divides the lane count (0 = all local devices; 1 = no sharding)",
    )
    parser.add_argument(
        "--interp", choices=["auto", "gather", "onehot", "onehot_weighted"],
        default="auto",
    )
    parser.add_argument(
        "--robust-delta", type=float, default=0.0,
        help="Huber robust weighting threshold in intensity units "
        "(0 = reference-exact L2)",
    )
    parser.add_argument(
        "--relocalize", type=int, default=0, metavar="K",
        help="in-graph lost-track recovery: each lane keeps its last K "
        "keyframes device-resident and, when its track fails or its "
        "photometric energy exceeds --relocalize-energy, re-solves against "
        "all of them and re-anchors to the best verified match (see "
        "parallel/batch.py RelocRing); 0 = off (reference-exact)",
    )
    parser.add_argument("--relocalize-energy", type=float, default=150.0)
    parser.add_argument(
        "--brightness-model", action="store_true",
        help="estimate per-frame affine brightness (gain/bias) jointly with "
        "the pose — for auto-exposure cameras",
    )
    parser.add_argument(
        "--candidate-selector", choices=["coarse_to_fine", "dso_fixed"],
        default="coarse_to_fine",
        help="keyframe candidate picker: coarse_to_fine (the reference "
        "tracker's selector) or dso_fixed (recursion-free DSO at a static "
        "--dso-block-size; the host-recursion 'dso' variant is streaming-"
        "Tracker-only — this fused driver runs its keyframe precompute "
        "in-graph)",
    )
    parser.add_argument(
        "--dso-target", type=int, default=2000,
        help="dso_fixed: point-count target for the random-thinning ratio",
    )
    parser.add_argument(
        "--dso-block-size", type=int, default=4,
        help="dso_fixed: the static block size (4 = the DSO-paper base)",
    )
    parser.add_argument(
        "--dso-a", type=float, default=1.0,
        help="DSO regional threshold coefficient a (lower on weak texture; "
        "see tools/accuracy_matrix.py)",
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
        "--save-state", metavar="PATH",
        help="checkpoint the batched serving state (TrackState + cadence "
        "carry + relocalization ring) to PATH after every chunk and at the "
        "end; resume with --resume on the SAME association files",
    )
    parser.add_argument(
        "--resume", metavar="PATH",
        help="restore a --save-state checkpoint and continue: consumed "
        "frames are skipped (trajectory files are appended to), the cadence "
        "phase continues from the saved global frame index, and the "
        "checkpoint is refused on config/cadence/sequence mismatch",
    )
    parser.add_argument(
        "--max-frames", type=int, default=0, metavar="N",
        help="stop after the first N frames per sequence (0 = all) — slice "
        "long runs into restartable pieces with --save-state/--resume",
    )
    args = parser.parse_args(argv)
    _common.apply_compilation_cache(args)
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    import jax
    import jax.numpy as jnp
    import numpy as np

    from ..dataset import tum_rgbd
    from ..math.pose import Pose
    from ..models import tracker as tracker_mod
    from ..parallel import batch as batch_mod
    from ..parallel import mesh as mesh_mod

    try:
        all_assocs = [tum_rgbd.load_associations(p) for p in args.associations_files]
    except OSError as e:
        print(USAGE, file=sys.stderr)
        print(f"Cannot read associations: {e}", file=sys.stderr)
        return 1
    if any(not a for a in all_assocs):
        print("Empty associations file", file=sys.stderr)
        return 1

    B = len(all_assocs)

    first = [tum_rgbd.read_images(a[0]) for a in all_assocs]
    shapes = {g.shape for _, g in first}
    if len(shapes) != 1:
        print(f"All sequences must share one image shape, got {shapes}", file=sys.stderr)
        return 1
    h, w = next(iter(shapes))
    intrinsics = tum_rgbd.scaled_intrinsics(args.camera_id, h, w)
    if (h, w) != (tum_rgbd.NATIVE_HEIGHT, tum_rgbd.NATIVE_WIDTH):
        print(f"note: {args.camera_id} intrinsics rescaled to {w}x{h} inputs", file=sys.stderr)

    config = tracker_mod.TrackerConfig(
        height=h,
        width=w,
        nb_levels=args.nb_levels,
        candidates_diff_threshold=args.diff_threshold,
        depth_scale=tum_rgbd.DEPTH_SCALE,
        idepth_variance=1e-4,
        candidate_cap=args.candidate_cap,
        interp_method=args.interp,
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

    # batch axis over the data mesh when it divides the device count
    local = jax.local_devices()
    n_dev = args.devices or len(local)
    if not 1 <= n_dev <= len(local):
        print(f"--devices {args.devices}: {len(local)} local devices", file=sys.stderr)
        return 1
    mesh = None
    if B % n_dev == 0 and n_dev > 1:
        mesh = mesh_mod.make_mesh((n_dev,), ("data",), local[:n_dev])
        print(f"sharding batch of {B} over {n_dev} devices", file=sys.stderr)

    d0 = jnp.asarray(np.stack([d for d, _ in first]))
    g0 = jnp.asarray(np.stack([g for _, g in first]))
    state = jax.jit(
        lambda d, g: batch_mod.batched_init_state(config, intrinsics, d, g)
    )(d0, g0)
    if mesh is not None:
        state = mesh_mod.shard_batch(state, mesh)

    # pending-lane mask and the global frame offset thread through chunks as
    # traced args, so cadence check-frame phase follows the GLOBAL frame index
    # and pending switch flags survive chunk boundaries (round-2 advisor
    # finding), without retracing per chunk.
    reloc_on = config.relocalize_window > 0
    vel_on = config.warm_start == "constant_velocity"

    @jax.jit
    def run_clip(s, dd, gg, pending, offset, rng, prev):
        outs = batch_mod.batched_track_sequence(
            config, intrinsics, s, dd, gg,
            switch_cadence=args.switch_cadence,
            switch_subbatch=args.switch_subbatch,
            pending0=pending, frame_offset=offset, return_pending=True,
            reloc_ring=rng if reloc_on else None,
            prev_pose0=prev if vel_on else None, return_prev=True,
        )
        # normalize to (final, out, pending, prev, ring)
        if reloc_on:
            return outs
        return outs + (rng,)

    os.makedirs(args.out_dir, exist_ok=True)
    # uniquify output names: two inputs mapping to the same name (same parent
    # directory name, or one directory holding several association files)
    # would otherwise silently clobber each other
    names = []
    seen = {}
    for p in args.associations_files:
        name = _out_name(p)
        if name in seen:
            seen[name] += 1
            stem, ext = os.path.splitext(name)
            name = f"{stem}.{seen[name]}{ext}"
        else:
            seen[name] = 0
        names.append(name)

    loaders = [iter(tum_rgbd.frame_loader(a[1:])) for a in all_assocs]
    lengths = [len(a) - 1 for a in all_assocs]
    max_len = max(lengths)
    if args.max_frames > 0:
        max_len = min(max_len, args.max_frames)
    last = [first[i] for i in range(B)]  # (depth, gray) to repeat when done

    frame_idx = 0
    pending = jnp.zeros((B,), bool)
    prev = state.current_pose  # zero velocity at start
    ring = (
        jax.jit(lambda s: batch_mod.batched_init_ring(config, s))(state)
        if reloc_on else jnp.int32(0)
    )

    from ..utils import checkpoint as checkpoint_mod

    out_mode = "w"
    if args.resume:
        try:
            (state_r, pending, ring_r, frame_idx, lane_ts,
             prev_r) = checkpoint_mod.load_batch(
                args.resume, state, ring if reloc_on else None,
                config, intrinsics, args.switch_cadence,
            )
        except checkpoint_mod.CheckpointMismatchError as e:
            print(f"Cannot resume: {e}", file=sys.stderr)
            return 1
        except (OSError, KeyError, ValueError) as e:
            print(f"Cannot read checkpoint {args.resume}: {e}", file=sys.stderr)
            return 1
        if len(lane_ts) != B:
            print(
                f"Cannot resume: checkpoint has {len(lane_ts)} lanes, "
                f"{B} association files given", file=sys.stderr,
            )
            return 1
        for b, ts in enumerate(lane_ts):
            if not checkpoint_mod.sequence_matches(ts, all_assocs[b]):
                print(
                    f"Cannot resume: lane {b} ({args.associations_files[b]}) "
                    "does not match the checkpoint's consumed frames — "
                    "resume with the SAME association files in the SAME "
                    "order", file=sys.stderr,
                )
                return 1
        state = state_r
        if reloc_on:
            ring = ring_r
        if vel_on and prev_r is not None:
            prev = prev_r
        if mesh is not None:
            state = mesh_mod.shard_batch(state, mesh)
            if reloc_on:
                ring = mesh_mod.shard_batch(ring, mesh)
            if vel_on:
                prev = mesh_mod.shard_batch(prev, mesh)
        # fast-forward the decode loaders past the consumed frames, keeping
        # each lane's last frame (finished lanes keep receiving it)
        for b in range(B):
            for _ in range(min(frame_idx, lengths[b])):
                last[b] = next(loaders[b])
        # reconcile output files to exactly the checkpoint's frame count:
        # a crash can land between the chunk's output flush and its
        # save_checkpoint, leaving lines PAST the checkpoint that the
        # resumed run would otherwise duplicate on append
        for b, name in enumerate(names):
            pth = os.path.join(args.out_dir, name)
            k = min(frame_idx, lengths[b])
            if os.path.exists(pth):
                with open(pth) as fh:
                    lines = fh.readlines()
                if len(lines) > k:
                    with open(pth, "w") as fh:
                        fh.writelines(lines[:k])
                    print(
                        f"[{b}] trimmed {len(lines) - k} output lines past "
                        "the checkpoint (crash between flush and save)",
                        file=sys.stderr,
                    )
                elif len(lines) == k and lines and not lines[-1].endswith("\n"):
                    # a crash mid-flush can truncate the final line while the
                    # line COUNT still matches the checkpoint; appending after
                    # a corrupt partial line would garble two TUM records
                    with open(pth, "w") as fh:
                        fh.writelines(lines[:-1])
                    print(
                        f"[{b}] dropped a truncated final line in {pth} "
                        "(crash mid-flush); that frame's pose line is lost",
                        file=sys.stderr,
                    )
                elif len(lines) < k:
                    print(
                        f"[{b}] warning: {pth} has {len(lines)} lines but "
                        f"the checkpoint consumed {k} frames — earlier "
                        "output is missing (different --out-dir?); the "
                        "resumed file will hold only frames from here on",
                        file=sys.stderr,
                    )
        out_mode = "a"  # append: lines for consumed frames already exist
        print(
            f"resumed {B} lanes at global frame {frame_idx}", file=sys.stderr
        )

    def save_checkpoint(next_frame_idx: int) -> None:
        lane_ts = [
            [a.depth_timestamp for a in all_assocs[b][: min(next_frame_idx, lengths[b]) + 1]]
            for b in range(B)
        ]
        checkpoint_mod.save_batch(
            args.save_state, state, pending, ring if reloc_on else None,
            next_frame_idx, config, intrinsics, args.switch_cadence, lane_ts,
            prev_pose=prev if vel_on else None,
        )

    outs = [open(os.path.join(args.out_dir, n), out_mode) for n in names]
    while frame_idx < max_len:
        n = min(args.chunk, max_len - frame_idx)
        clip_d = np.empty((n, B, h, w), np.uint16)
        clip_g = np.empty((n, B, h, w), np.uint8)
        for f in range(n):
            for b in range(B):
                if frame_idx + f < lengths[b]:
                    last[b] = next(loaders[b])
                clip_d[f, b], clip_g[f, b] = last[b]
        dd = jnp.asarray(clip_d)
        gg = jnp.asarray(clip_g)
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            sh = NamedSharding(mesh, P(None, "data"))
            dd = jax.device_put(dd, sh)
            gg = jax.device_put(gg, sh)
        state, (poses, diags), pending, prev, ring = run_clip(
            state, dd, gg, pending, jnp.int32(frame_idx), ring, prev
        )
        q = np.asarray(poses.q)
        t = np.asarray(poses.t)
        flows = np.asarray(diags.flow)
        relocs = np.asarray(diags.relocalized)
        for f in range(n):
            for b in range(B):
                fi = frame_idx + f
                if fi >= lengths[b]:
                    continue
                a = all_assocs[b][fi + 1]
                print(f"[{b}] Optical_flow: {flows[f, b]}", file=sys.stderr)
                if relocs[f, b]:
                    print(f"[{b}] Relocalized against keyframe ring",
                          file=sys.stderr)
                line = tum_rgbd.Frame(
                    timestamp=a.depth_timestamp, pose=Pose(q=q[f, b], t=t[f, b])
                ).to_string()
                outs[b].write(line + "\n")
        frame_idx += n
        if args.save_state:
            for fh in outs:
                fh.flush()
            save_checkpoint(frame_idx)

    for fh in outs:
        fh.close()
    print(f"wrote {B} trajectories to {args.out_dir}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
