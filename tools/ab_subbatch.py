"""A/B: sub-batch switch-lane compaction vs all-lanes recompute.

With diverse lanes nearly every frame has SOME pending lane, so the
all-lanes batched keyframe recompute rides along on most frames.
``switch_subbatch=K`` precomputes only the (typically 1-4) pending lanes,
compacted into a fixed K-lane sub-batch with bit-exact one-hot byte-plane
matmuls (``parallel/batch.py``).

Run:  python tools/ab_subbatch.py [B ...]
Prints one JSON line per (B, K) to stdout; compare within one process.
"""

import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main() -> int:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from visual_odometry_rs_tpu.dataset import synthetic
    from visual_odometry_rs_tpu.models import tracker as tracker_mod
    from visual_odometry_rs_tpu.parallel import batch as batch_mod

    batches = [int(a) for a in sys.argv[1:]] or [8, 32]
    import os

    ks = tuple(
        int(k) for k in os.environ.get("AB_SUBBATCH_KS", "0,2,4,8").split(",")
    )

    h, w, F = 480, 640, 10
    config = tracker_mod.TrackerConfig(height=h, width=w, nb_levels=6, candidate_cap=4096)

    cache_file = (
        pathlib.Path(__file__).resolve().parents[1]
        / ".bench_cache" / f"diverse_v2_32x{F}_{h}x{w}.npz"
    )
    base = synthetic.generate_sequence(nb_frames=1, height=h, width=w, seed=0)
    intr = base.intrinsics
    data = np.load(cache_file)
    div_grays, div_depths = data["grays"], data["depths"]

    for B in batches:
        state = jax.jit(
            lambda d, g: batch_mod.batched_init_state(config, intr, d, g)
        )(jnp.asarray(div_depths[:B, 0]), jnp.asarray(div_grays[:B, 0]))
        clip_d = jnp.asarray(div_depths[:B, 1:].transpose(1, 0, 2, 3))
        clip_g = jnp.asarray(div_grays[:B, 1:].transpose(1, 0, 2, 3))

        ref_t = None
        for K in ks:
            if K >= B:
                continue

            run_clip = jax.jit(
                lambda s, dd, gg, K=K: batch_mod.batched_track_sequence(
                    config, intr, s, dd, gg, switch_subbatch=K
                )
            )
            final, (poses, diags) = run_clip(state, clip_d, clip_g)
            jax.block_until_ready(final.current_pose.t)
            assert not bool(diags.failed.any())
            switch_frames = int(jnp.any(diags.switched, axis=1).sum())
            max_pending = int(jnp.sum(diags.switched, axis=1).max())
            if ref_t is None:
                ref_t = np.asarray(poses.t)
            drift = float(np.max(np.abs(np.asarray(poses.t) - ref_t)))
            n = 4
            t0 = time.perf_counter()
            for _ in range(n):
                final, _ = run_clip(state, clip_d, clip_g)
            jax.block_until_ready(final.current_pose.t)
            fps = n * F * B / (time.perf_counter() - t0)
            print(
                json.dumps(
                    {"batch": B, "subbatch": K, "fps_per_chip": round(fps, 1),
                     "switch_frames": switch_frames,
                     "max_lanes_pending": max_pending,
                     "max_t_diff_vs_K0": drift}
                ),
                flush=True,
            )
    return 0


if __name__ == "__main__":
    sys.exit(main())
