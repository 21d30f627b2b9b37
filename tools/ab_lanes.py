"""A/B: fps/chip vs lane count B in the fused diverse scan, one process.

Sweeps B at the diverse operating point (cadence 1, switch_subbatch=B/4)
so "more lanes per chip" is quantified with its per-step latency.

Lane data: ONE 64-lane diverse superset rendered with the bench.py ladder
(motion magnitudes 0.004..0.04 m/frame spread over the 64 lanes, per-lane
textures + directions + rotations, seeds 200+lane) and cached under
.bench_cache.  Each smaller B takes every (64/B)-th lane, so every B sees
the SAME magnitude range and distribution shape — switch-frame density
stays comparable across rows (reported per row; an fps/chip comparison
where smaller B dodged the switches would be meaningless).

Run:  python tools/ab_lanes.py
      AB_LANES_ROWS=32:8,64:16 python ...      (subset, "B:subbatch" pairs)
      AB_LANES_SUPER=128 AB_LANES_ROWS=...     (bigger superset; every B
                                                strides the SAME superset)

One JSON line per row.  Compare rows within one process only.
"""

import json
import os
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

B_SUPER = int(os.environ.get("AB_LANES_SUPER", "64"))
DEFAULT_ROWS = "16:4,32:8,64:8,64:16"


def _superset(cache_dir: pathlib.Path, h: int, w: int, F: int,
              n_lanes: int = B_SUPER):
    """Render (or load) the n-lane diverse superset: (B, F+1, H, W) pairs."""
    import numpy as np

    from visual_odometry_rs_tpu.dataset import synthetic

    cache_file = cache_dir / f"diverse_lanes_v1_{n_lanes}x{F}_{h}x{w}.npz"
    if cache_file.exists():
        data = np.load(cache_file)
        return data["grays"], data["depths"]
    base = synthetic.generate_sequence(
        nb_frames=2, height=h, width=w, seed=0, motion_scale=0.008
    )
    rng = np.random.default_rng(43)
    grays, depths = [], []
    t0 = time.perf_counter()
    for lane in range(n_lanes):
        mag = 0.004 + 0.036 * lane / (n_lanes - 1)
        direction = rng.normal(size=3)
        direction = mag * direction / np.linalg.norm(direction)
        rot = 0.002 * rng.normal(size=3)
        seq = synthetic.generate_sequence(
            nb_frames=F + 1, height=h, width=w, seed=200 + lane,
            intrinsics=base.intrinsics,
            twist_per_frame=np.concatenate([direction, rot]),
        )
        grays.append(seq.grays)
        depths.append(seq.depths)
        print(f"rendered lane {lane + 1}/{n_lanes} "
              f"({time.perf_counter() - t0:.0f}s)", file=sys.stderr)
    grays = np.stack(grays)
    depths = np.stack(depths)
    cache_dir.mkdir(exist_ok=True)
    np.savez_compressed(cache_file, grays=grays, depths=depths)
    return grays, depths


def main() -> int:
    import jax

    from visual_odometry_rs_tpu.cli import _common

    # same persistent XLA compile cache as bench.py and the CLIs
    _common.enable_compilation_cache()

    import jax.numpy as jnp

    from visual_odometry_rs_tpu.dataset import synthetic
    from visual_odometry_rs_tpu.models import tracker as tracker_mod
    from visual_odometry_rs_tpu.parallel import batch as batch_mod

    rows = []
    for item in os.environ.get("AB_LANES_ROWS", DEFAULT_ROWS).split(","):
        b, k = item.split(":")
        rows.append((int(b), int(k)))

    h, w, F = 480, 640, 10
    config = tracker_mod.TrackerConfig(
        height=h, width=w, nb_levels=6, candidate_cap=4096
    )
    base = synthetic.generate_sequence(
        nb_frames=2, height=h, width=w, seed=0, motion_scale=0.008
    )
    intr = base.intrinsics
    cache_dir = pathlib.Path(__file__).resolve().parents[1] / ".bench_cache"
    grays, depths = _superset(cache_dir, h, w, F)

    for B, subbatch in rows:
        assert B_SUPER % B == 0, f"B={B} must divide {B_SUPER}"
        stride = B_SUPER // B
        d = depths[::stride]
        g = grays[::stride]
        d0 = jnp.asarray(d[:, 0])
        g0 = jnp.asarray(g[:, 0])
        clip_d = jnp.asarray(d[:, 1:].transpose(1, 0, 2, 3))  # (F, B, H, W)
        clip_g = jnp.asarray(g[:, 1:].transpose(1, 0, 2, 3))
        state = jax.jit(
            lambda dd, gg: batch_mod.batched_init_state(config, intr, dd, gg)
        )(d0, g0)
        run_clip = jax.jit(
            lambda s, dd, gg, k=subbatch: batch_mod.batched_track_sequence(
                config, intr, s, dd, gg, switch_subbatch=k
            )
        )
        final, (poses, diags) = run_clip(state, clip_d, clip_g)
        jax.block_until_ready(final.current_pose.t)
        n = 4
        t0 = time.perf_counter()
        for _ in range(n):
            final, _ = run_clip(state, clip_d, clip_g)
        jax.block_until_ready(final.current_pose.t)
        dt = time.perf_counter() - t0
        fps = n * F * B / dt
        print(
            json.dumps(
                {
                    "batch": B, "subbatch": subbatch,
                    "fps_per_chip": round(fps, 1),
                    "ms_per_step": round(1e3 * dt / (n * F), 2),
                    "n_failed": int(jnp.sum(diags.failed)),
                    "switch_frames": int(
                        jnp.asarray(diags.switched).any(axis=1).sum()
                    ),
                    "mean_switches_per_frame": round(
                        float(jnp.asarray(diags.switched).sum()) / F, 2
                    ),
                }
            ),
            flush=True,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
