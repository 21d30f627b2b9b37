"""Same-process A/B of the bilinear samplers on the attached accelerator.

Times ``gather``, ``onehot`` and ``onehot_weighted`` in two contexts at
640x480, 6 levels, candidate cap 4096:

- single stream: one jitted pyramid + ``track_frame`` per frame;
- the B-lane diverse fused scan (``batched_track_sequence``, one dispatch
  per clip of F frames; the lanes of ``chip_smoke.render_lanes``).

Every timed program returns its whole output tree, so XLA cannot drop the
work under test.  The methods run in two rounds, in order and then in
reverse, so drift on the card shows as a difference between rounds.  One
JSON line per row on stdout, each with the device it ran on.

Usage: python tools/ab_interp_scan.py [--batch 32] [--frames 10] [--cap 4096]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

METHODS = ("gather", "onehot", "onehot_weighted")


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--frames", type=int, default=10)
    parser.add_argument("--cap", type=int, default=4096)
    parser.add_argument("--clips", type=int, default=3)
    parser.add_argument("--single-iters", type=int, default=30)
    parser.add_argument("--methods", nargs="+", default=list(METHODS))
    args = parser.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    import chip_smoke
    from visual_odometry_rs_tpu.cli import _common
    from visual_odometry_rs_tpu.math import pose as pose_mod
    from visual_odometry_rs_tpu.models import tracker as tracker_mod
    from visual_odometry_rs_tpu.ops import pyramid as pyramid_ops
    from visual_odometry_rs_tpu.parallel import batch as batch_mod

    _common.enable_compilation_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"ab_interp_scan: no GPU (default device: {dev.platform})")
    device = {"platform": dev.platform, "kind": dev.device_kind}
    height, width = chip_smoke.H, chip_smoke.W
    B, F = args.batch, args.frames
    t0 = time.perf_counter()
    lanes = chip_smoke.render_lanes(height, width, n_lanes=B, nb_frames=F + 1)
    print(f"rendered {B}x{F + 1} frames in {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    intrinsics = lanes[0].intrinsics
    grays = np.stack([s.grays for s in lanes])  # (B, F+1, H, W)
    depths = np.stack([s.depths for s in lanes])
    d0, g0 = jnp.asarray(depths[:, 0]), jnp.asarray(grays[:, 0])
    clip_d = jnp.asarray(depths[:, 1:].transpose(1, 0, 2, 3))  # (F, B, H, W)
    clip_g = jnp.asarray(grays[:, 1:].transpose(1, 0, 2, 3))
    single_frames = [jnp.asarray(g) for g in grays[0, 1:]]

    def config_for(method):
        return tracker_mod.TrackerConfig(
            height=height, width=width, nb_levels=6, candidate_cap=args.cap,
            interp_method=method,
        )

    programs = {}
    for method in args.methods:
        config = config_for(method)

        @jax.jit
        def per_frame(kf, img, init, c=config):
            pyr = pyramid_ops.mean_pyramid(c.nb_levels, img)
            return tracker_mod.track_frame(c, kf, pyr, init)

        kf = jax.jit(
            lambda d, g, c=config: tracker_mod.precompute_keyframe(
                c, intrinsics, d, pyramid_ops.mean_pyramid(c.nb_levels, g)
            )
        )(d0[0], g0[0])
        state = jax.jit(
            lambda d, g, c=config: batch_mod.batched_init_state(c, intrinsics, d, g)
        )(d0, g0)
        run_clip = jax.jit(
            lambda s, dd, gg, c=config: batch_mod.batched_track_sequence(
                c, intrinsics, s, dd, gg
            )
        )
        t0 = time.perf_counter()
        jax.block_until_ready(per_frame(kf, single_frames[0], pose_mod.identity()))
        final, (poses, diags) = run_clip(state, clip_d, clip_g)
        jax.block_until_ready((final, poses, diags))
        assert not bool(diags.failed.any()), f"{method}: track failed"
        print(f"{method}: compiled in {time.perf_counter() - t0:.1f} s", file=sys.stderr)
        programs[method] = (per_frame, kf, state, run_clip)

    for rnd, order in enumerate((args.methods, args.methods[::-1])):
        for method in order:
            per_frame, kf, state, run_clip = programs[method]
            ident = pose_mod.identity()
            start = time.perf_counter()
            for i in range(args.single_iters):
                out = per_frame(kf, single_frames[i % len(single_frames)], ident)
            jax.block_until_ready(out)
            single_ms = 1e3 * (time.perf_counter() - start) / args.single_iters
            start = time.perf_counter()
            for _ in range(args.clips):
                out = run_clip(state, clip_d, clip_g)
            jax.block_until_ready(out)
            scan_s = (time.perf_counter() - start) / args.clips
            print(json.dumps({
                "round": rnd, "method": method, "device": device,
                "single_stream_ms_per_frame": single_ms,
                "single_stream_fps": 1e3 / single_ms,
                f"scan_b{B}_diverse_ms_per_step": 1e3 * scan_s / F,
                f"scan_b{B}_diverse_fps": B * F / scan_s,
            }), flush=True)


if __name__ == "__main__":
    main()
