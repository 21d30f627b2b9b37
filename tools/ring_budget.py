"""RelocRing HBM budget at arbitrary shapes (no device needed).

The in-graph relocalization ring (``parallel.batch.RelocRing``) carries R
complete ``KeyframeData`` pytrees per lane — per-candidate channels at
every pyramid level plus the template pyramid images.  This tool prints
the exact per-lane and total device footprint from ``jax.eval_shape`` (no
allocation), for the production operating point and any
``--batch/--cap/--slots/--levels`` override.

    python tools/ring_budget.py
    python tools/ring_budget.py --batch 32 --cap 8192 --slots 4
"""

import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--cap", type=int, default=8192)
    parser.add_argument("--slots", type=int, default=4)
    parser.add_argument("--levels", type=int, default=6)
    parser.add_argument("--height", type=int, default=480)
    parser.add_argument("--width", type=int, default=640)
    args = parser.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from visual_odometry_rs_tpu.dataset import synthetic
    from visual_odometry_rs_tpu.models import tracker as tracker_mod
    from visual_odometry_rs_tpu.parallel import batch as batch_mod

    config = tracker_mod.TrackerConfig(
        height=args.height, width=args.width, nb_levels=args.levels,
        candidate_cap=args.cap, relocalize_window=args.slots,
    )
    seq = synthetic.generate_sequence(
        nb_frames=1, height=args.height, width=args.width, seed=0
    )
    B = args.batch
    d0 = jnp.zeros((B, args.height, args.width), jnp.uint16)
    g0 = jnp.zeros((B, args.height, args.width), jnp.uint8)

    def build(d, g):
        state = batch_mod.batched_init_state(config, seq.intrinsics, d, g)
        ring = batch_mod.batched_init_ring(config, state)
        return state, ring

    state_s, ring_s = jax.eval_shape(build, d0, g0)

    def tree_bytes(t):
        return sum(
            int(np.prod(l.shape)) * l.dtype.itemsize
            for l in jax.tree_util.tree_leaves(t)
            if hasattr(l, "shape")
        )

    import numpy as np  # noqa: E402  (after eval_shape; only for prod)

    state_b = tree_bytes(state_s)
    ring_b = tree_bytes(ring_s)
    print(json.dumps({
        "batch": B, "cap": args.cap, "slots": args.slots,
        "levels": args.levels, "hw": [args.height, args.width],
        "track_state_mb": round(state_b / 2**20, 1),
        "ring_mb": round(ring_b / 2**20, 1),
        "ring_mb_per_lane": round(ring_b / B / 2**20, 2),
        "ring_over_state": round(ring_b / max(state_b, 1), 2),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
