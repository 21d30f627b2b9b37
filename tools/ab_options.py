"""A/B: serving cost of the tracker product options in the fused scan.

Measures the product knobs at the diverse operating point (B=32, cadence
1, switch_subbatch=8); the relocalization layer has its own tool
(tools/ab_reloc_cost.py):

- ``robust_delta`` (Huber reweighting inside every LM iteration,
  models/tracker.py solve_level)
- ``brightness_model`` (the 8-parameter pose+gain/bias solve,
  models/tracker.py solve_level_brightness — a DIFFERENT normal system,
  not a reweighting)
- both together
- ``dso_fixed`` (the in-graph DSO selector: replaces the coarse-to-fine
  candidate pass inside the keyframe precompute branch)

Run:  python tools/ab_options.py
      AB_OPTIONS_VARIANTS=plain,huber python ...   (subset)

One JSON line per variant.  Compare rows within one process only.
Accuracy of each knob is gated separately by tools/accuracy_matrix.py on CPU.
"""

import json
import os
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

VARIANTS = {
    # name -> TrackerConfig overrides
    "plain": {},
    "huber": {"robust_delta": 10.0},
    "brightness": {"brightness_model": True},
    "huber_brightness": {"robust_delta": 10.0, "brightness_model": True},
    "dso_fixed": {"candidate_selector": "dso_fixed",
                  "dso_threshold_coef_a": 0.2},
}


def main() -> int:
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    from visual_odometry_rs_tpu.dataset import synthetic
    from visual_odometry_rs_tpu.models import tracker as tracker_mod
    from visual_odometry_rs_tpu.parallel import batch as batch_mod

    names = [
        v for v in os.environ.get(
            "AB_OPTIONS_VARIANTS", ",".join(VARIANTS)
        ).split(",") if v
    ]
    B = int(os.environ.get("AB_OPTIONS_B", "32"))
    subbatch = int(os.environ.get("AB_OPTIONS_SUBBATCH", "8"))

    h, w, F = 480, 640, 10
    base_config = tracker_mod.TrackerConfig(
        height=h, width=w, nb_levels=6, candidate_cap=4096
    )
    base = synthetic.generate_sequence(nb_frames=2, height=h, width=w,
                                       seed=0, motion_scale=0.008)
    intr = base.intrinsics
    cache_file = (
        pathlib.Path(__file__).resolve().parents[1]
        / ".bench_cache" / f"diverse_v2_32x{F}_{h}x{w}.npz"
    )
    data = np.load(cache_file)
    d0 = jnp.asarray(data["depths"][:B, 0])
    g0 = jnp.asarray(data["grays"][:B, 0])
    clip_d = jnp.asarray(data["depths"][:B, 1:].transpose(1, 0, 2, 3))
    clip_g = jnp.asarray(data["grays"][:B, 1:].transpose(1, 0, 2, 3))

    for name in names:
        config = dataclasses.replace(base_config, **VARIANTS[name])
        state = jax.jit(
            lambda d, g, config=config: batch_mod.batched_init_state(
                config, intr, d, g
            )
        )(d0, g0)
        run_clip = jax.jit(
            lambda s, dd, gg, config=config: batch_mod.batched_track_sequence(
                config, intr, s, dd, gg, switch_subbatch=subbatch
            )
        )
        final, (poses, diags) = run_clip(state, clip_d, clip_g)
        jax.block_until_ready(final.current_pose.t)
        n = 4
        t0 = time.perf_counter()
        for _ in range(n):
            final, _ = run_clip(state, clip_d, clip_g)
        jax.block_until_ready(final.current_pose.t)
        fps = n * F * B / (time.perf_counter() - t0)
        print(
            json.dumps(
                {
                    "variant": name, "batch": B, "subbatch": subbatch,
                    "fps_per_chip": round(fps, 1),
                    "ms_per_step": round(1e3 * B / fps, 2),
                    "n_failed": int(jnp.sum(diags.failed)),
                    "switch_frames": int(
                        jnp.asarray(diags.switched).any(axis=1).sum()
                    ),
                }
            ),
            flush=True,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
