"""Per-chip batching scaling curve: fused-scan throughput vs batch size.

How close does throughput scale with the number of concurrent sequences on
one chip?  Perfect batching would be linear until the device saturates;
the curve shows where that knee is.

Run:  python tools/scaling_bench.py
Prints one JSON line per batch size to stdout.
"""

import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main() -> int:
    import jax
    import jax.numpy as jnp

    from visual_odometry_rs_tpu.dataset import synthetic
    from visual_odometry_rs_tpu.models import tracker as tracker_mod
    from visual_odometry_rs_tpu.parallel import batch as batch_mod

    import numpy as np

    h, w, F = 480, 640, 10
    config = tracker_mod.TrackerConfig(height=h, width=w, nb_levels=6, candidate_cap=4096)

    # DIVERSE lanes (distinct textures + motion magnitudes) so keyframe
    # switches desynchronize — same honesty standard as bench.py; reuses
    # bench.py's on-disk cache when present.
    import pathlib as _pl

    cache_file = (
        _pl.Path(__file__).resolve().parents[1]
        / ".bench_cache" / f"diverse_v2_32x{F}_{h}x{w}.npz"
    )
    base = synthetic.generate_sequence(nb_frames=1, height=h, width=w, seed=0)
    intr = base.intrinsics
    if cache_file.exists():
        data = np.load(cache_file)
        div_grays, div_depths = data["grays"], data["depths"]
    else:
        rng = np.random.default_rng(42)
        seqs = []
        for lane in range(32):
            mag = 0.004 + 0.036 * lane / 31
            direction = rng.normal(size=3)
            direction = mag * direction / np.linalg.norm(direction)
            rot = 0.002 * rng.normal(size=3)
            seqs.append(
                synthetic.generate_sequence(
                    nb_frames=F + 1, height=h, width=w, seed=100 + lane,
                    intrinsics=intr,
                    twist_per_frame=np.concatenate([direction, rot]),
                )
            )
        div_grays = np.stack([s.grays for s in seqs])
        div_depths = np.stack([s.depths for s in seqs])
        cache_file.parent.mkdir(exist_ok=True)
        np.savez_compressed(cache_file, grays=div_grays, depths=div_depths)

    base_fps = None
    for B in (1, 2, 4, 8, 16, 32):
        state = jax.jit(
            lambda d, g: batch_mod.batched_init_state(config, intr, d, g)
        )(jnp.asarray(div_depths[:B, 0]), jnp.asarray(div_grays[:B, 0]))
        clip_d = jnp.asarray(div_depths[:B, 1:].transpose(1, 0, 2, 3))
        clip_g = jnp.asarray(div_grays[:B, 1:].transpose(1, 0, 2, 3))

        @jax.jit
        def run_clip(s, dd, gg):
            return batch_mod.batched_track_sequence(config, intr, s, dd, gg)

        final, (_, diags) = run_clip(state, clip_d, clip_g)
        jax.block_until_ready(final.current_pose.t)
        assert not bool(diags.failed.any())
        n = 4
        t0 = time.perf_counter()
        for _ in range(n):
            final, _ = run_clip(state, clip_d, clip_g)
        jax.block_until_ready(final.current_pose.t)
        fps = n * F * B / (time.perf_counter() - t0)
        if base_fps is None:
            base_fps = fps
        eff = fps / (base_fps * B)
        print(
            json.dumps(
                {"batch": B, "fps_per_chip": round(fps, 1),
                 "scaling_efficiency_vs_b1": round(eff, 3)}
            ),
            flush=True,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
