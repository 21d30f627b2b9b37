"""A/B: LM warm start + per-level iteration budgets, one process.

The diverse tracking floor (vmapped lanes paying worst-case LM schedules)
has two levers:

- ``warm_start="constant_velocity"``: extrapolate the previous inter-frame
  motion into the init (the reference restarts from the previous POSE,
  inverse_compositional.rs:177).  A closer init converges in fewer LM
  iterations; under vmap the while_loop runs to the max over lanes, so the
  win shows up when the whole batch's iteration distribution shifts down.
- ``level_max_iterations``: per-level caps below the reference's uniform 20
  (lm_optimizer.rs:157).  The coarse levels only seed the next level's
  init; their worst case may be cheap to cut.

Run:  python tools/ab_warmstart.py
      AB_WARMSTART_VARIANTS=cp,cv python ...  (subset)

Prints one JSON line per variant (fps, per-level mean/max LM iterations
over the clip, final-pose drift vs the reference variant).  Compare within
one process only.  Accuracy gates live in tools/accuracy_matrix.py (CPU,
synthetic ground truth).
"""

import json
import os
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

VARIANTS = {
    # name -> (warm_start, level_max_iterations or None)
    "cp": ("constant_position", None),
    "cv": ("constant_velocity", None),
    "cp_budget_c10": ("constant_position", (20, 20, 20, 10, 10, 10)),
    "cp_budget_c5": ("constant_position", (20, 20, 10, 10, 5, 5)),
    "cv_budget_c10": ("constant_velocity", (20, 20, 20, 10, 10, 10)),
    "cv_budget_c5": ("constant_velocity", (20, 20, 10, 10, 5, 5)),
    "cv_budget_aggr": ("constant_velocity", (15, 10, 8, 5, 5, 5)),
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
            "AB_WARMSTART_VARIANTS", ",".join(VARIANTS)
        ).split(",") if v
    ]
    B = int(os.environ.get("AB_WARMSTART_B", "32"))
    subbatch = int(os.environ.get("AB_WARMSTART_SUBBATCH", "8"))
    modes = os.environ.get("AB_WARMSTART_MODES", "diverse,broadcast").split(",")

    h, w, F = 480, 640, 10
    base_config = tracker_mod.TrackerConfig(
        height=h, width=w, nb_levels=6, candidate_cap=4096
    )

    cache_file = (
        pathlib.Path(__file__).resolve().parents[1]
        / ".bench_cache" / f"diverse_v2_32x{F}_{h}x{w}.npz"
    )
    base = synthetic.generate_sequence(nb_frames=F + 1, height=h, width=w,
                                       seed=0, motion_scale=0.008)
    intr = base.intrinsics
    data = np.load(cache_file)
    div_grays, div_depths = data["grays"], data["depths"]

    for mode in modes:
        if mode in ("diverse", "diverse_floor"):
            d0 = jnp.asarray(div_depths[:B, 0])
            g0 = jnp.asarray(div_grays[:B, 0])
            clip_d = jnp.asarray(div_depths[:B, 1:].transpose(1, 0, 2, 3))
            clip_g = jnp.asarray(div_grays[:B, 1:].transpose(1, 0, 2, 3))
        else:  # broadcast: identical lanes, switch cond never fires
            d0 = jnp.broadcast_to(jnp.asarray(base.depths[0]), (B, h, w))
            g0 = jnp.broadcast_to(jnp.asarray(base.grays[0]), (B, h, w))
            clip_d = jnp.broadcast_to(
                jnp.asarray(base.depths[1:])[:, None], (F, B, h, w)
            )
            clip_g = jnp.broadcast_to(
                jnp.asarray(base.grays[1:])[:, None], (F, B, h, w)
            )

        ref_t = None
        for name in names:
            warm, budget = VARIANTS[name]
            config = dataclasses.replace(
                base_config, warm_start=warm, level_max_iterations=budget
            )
            if mode == "diverse_floor":
                # pure tracking floor: switches disabled (the
                # ab_step_decompose "diverse_noswitch" methodology)
                config = dataclasses.replace(
                    config, flow_threshold=float("inf")
                )
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
            n_failed = int(jnp.sum(diags.failed))
            iters = np.asarray(diags.nb_iters)  # (F, B, L)
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
                    {
                        "mode": mode, "variant": name, "batch": B,
                        "subbatch": subbatch,
                        "fps_per_chip": round(fps, 1),
                        "iters_mean_per_level": [
                            round(float(m), 2)
                            for m in iters.mean(axis=(0, 1))
                        ],
                        "iters_max_per_level": [
                            int(m) for m in iters.max(axis=(0, 1))
                        ],
                        "iters_total_mean": round(
                            float(iters.sum(axis=2).mean()), 1
                        ),
                        "n_failed": n_failed,
                        "max_t_drift_vs_ref": drift,
                    }
                ),
                flush=True,
            )
    return 0


if __name__ == "__main__":
    sys.exit(main())
